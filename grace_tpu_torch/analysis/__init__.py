"""The static auditor of the port; counterpart of the JAX package's
``analysis/`` (its graft-lint and graft-flow layers).

It traces any registered codec × communicator × resilience config with no
card and no peers: one rank's real step over a process group of PyTorch's
``"fake"`` backend at any world size, on ``FakeTensor``\\ s, on the card's
route (the kernel wrappers' fake branches) or the CPU's
(:mod:`.trace`). Ten passes walk the record:

* ``collective_consistency`` — a host read of a rank-varying value ahead
  of a collective (the port's form of a divergent ``lax.cond``);
* ``bit_exactness`` — bit-pattern data reaching a float reduction;
* ``wire_reconciliation`` — the received bytes counted from the step's
  c10d ops against the wire model telemetry trusts;
* ``signature_stability`` — the state's signature a fixed point of the
  update, and no host read inside a step that the contract does not name;
* ``overlap_schedulability``, ``numeric_safety``, ``memory_footprint`` —
  the dependence-graph passes (:mod:`.flow`);
* ``rng_lineage``, ``rollback_coverage``, ``replication_contract`` — the
  state passes (:mod:`.state_passes`): the step's random draws, the
  guard's rollback of every leaf it writes, and the replicated fields'
  agreement across ranks (a trace against its twin taken as rank W−1).

:mod:`.configs` holds the JAX package's 79-entry registry; ``python -m
grace_tpu_torch.analysis --all-configs`` audits it and ``--rules`` runs
the four AST repo rules (:mod:`.rules`) over the port's source (the
counterpart of ``tools/graft_lint.py``).
"""

from grace_tpu_torch.analysis.trace import (Branch, TracedGraph,
                                            default_param_structs,
                                            fake_world, trace_fn,
                                            trace_train_step, trace_update)
from grace_tpu_torch.analysis.passes import (Finding, PASS_NAMES,
                                             count_recv_bytes,
                                             count_recv_link_bytes,
                                             pass_bit_exactness,
                                             pass_collective_consistency,
                                             pass_signature_stability,
                                             pass_wire_reconciliation,
                                             run_passes)
from grace_tpu_torch.analysis.flow import (DepGraph, DepNode, build_depgraph,
                                           footprint_model, footprint_report,
                                           overlap_summary,
                                           pass_memory_footprint,
                                           pass_numeric_safety,
                                           pass_overlap_schedulability)
from grace_tpu_torch.analysis.state_passes import (
    STATE_PASS_NAMES, pass_replication_contract, pass_rng_lineage,
    pass_rollback_coverage)
from grace_tpu_torch.analysis.rules import RULE_NAMES, run_repo_rules
from grace_tpu_torch.analysis.configs import (AUDIT_CONFIGS, audit_all,
                                              audit_config, branches,
                                              build_grace,
                                              overlap_bound_report)
from grace_tpu_torch.analysis.report import (findings_to_json, render_text,
                                             write_jsonl)

__all__ = [
    "Branch", "TracedGraph", "default_param_structs", "fake_world",
    "trace_fn", "trace_update", "trace_train_step",
    "Finding", "PASS_NAMES", "run_passes", "count_recv_bytes",
    "count_recv_link_bytes",
    "pass_collective_consistency", "pass_bit_exactness",
    "pass_wire_reconciliation", "pass_signature_stability",
    "DepGraph", "DepNode", "build_depgraph", "overlap_summary",
    "footprint_model", "footprint_report",
    "pass_overlap_schedulability", "pass_numeric_safety",
    "pass_memory_footprint",
    "STATE_PASS_NAMES", "pass_rng_lineage", "pass_rollback_coverage",
    "pass_replication_contract", "RULE_NAMES", "run_repo_rules",
    "AUDIT_CONFIGS", "audit_all", "audit_config", "branches", "build_grace",
    "overlap_bound_report",
    "findings_to_json", "render_text", "write_jsonl",
]
