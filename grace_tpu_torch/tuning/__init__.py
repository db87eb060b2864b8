"""The topology-aware tuner; counterpart of the JAX package's ``tuning/``.

It turns the static auditor and the per-link wire model into a decision.
Given a model's parameters and a target topology, it

1. **enumerates** codec × communicator × fusion × kernel candidates from
   the auditor's registry and generated variants (:mod:`.candidates`),
   with the communicators' own capability gates;
2. **prunes statically** (:mod:`.prune`): numeric safety and requant
   degradation at the target world, the wire-dominated price under the
   target topology (:mod:`.cost`, the port's own H100 figures), flow
   passes 5–7 over the ranked head's traces — every rejection with its
   reason;
3. **measures the shortlist** (:mod:`.measure`): timed steps of each
   candidate against the interleaved dense anchor in one process, each
   candidate's own step put back into the cost model;
4. **stamps the winner**: a ``grace_from_params`` config with the
   topology, the funnel and the measured≤static overlap sandwich as its
   honesty gate, written by :func:`write_tune_evidence`
   (``grace_tpu_torch/TUNE_LAST.json`` by default, outside version
   control).

The static stage traces over a fake default process group and runs first,
where no default group may exist; the measured stage then makes its
group (:func:`.measure.measuring_group`). :func:`write_tune_evidence` also
records the winner in the port's evidence ledger (``tune-winner``,
:mod:`grace_tpu_torch.evidence`). Command line: ``python -m
grace_tpu_torch.tuning``.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from grace_tpu_torch.tuning.candidates import (Candidate, candidate_legal,
                                               enumerate_candidates,
                                               variant_audit_entries)
from grace_tpu_torch.tuning.cost import (PROJECTION_MODEL, TuneTopology,
                                         price_candidate,
                                         projection_constants)
from grace_tpu_torch.tuning.measure import (MeasureTimeout, bounded_call,
                                            build_model_step,
                                            measure_shortlist,
                                            measuring_group, model_structs,
                                            overlap_sandwich)
from grace_tpu_torch.tuning.online import (ONLINE_MEASURE_TIMEOUT_S,
                                           online_funnel)
from grace_tpu_torch.tuning.prune import numeric_verdict, static_prune

__all__ = ["Candidate", "MeasureTimeout", "ONLINE_MEASURE_TIMEOUT_S",
           "PROJECTION_MODEL", "TuneTopology", "bounded_call",
           "build_model_step", "candidate_legal", "enumerate_candidates",
           "measure_shortlist", "measuring_group", "model_structs",
           "numeric_verdict", "online_funnel", "overlap_sandwich",
           "price_candidate", "projection_constants", "run_tune",
           "static_prune", "variant_audit_entries", "write_tune_evidence",
           "TUNE_EVIDENCE_PATH"]

# The port's own evidence file (the repository root's TUNE_LAST.json is
# the JAX tuner's).
TUNE_EVIDENCE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "TUNE_LAST.json")


def run_tune(topologies: Sequence[Union[str, TuneTopology]], *,
             model: str = "toy", shortlist_n: int = 3,
             static_only: bool = False, audit_world: int = 8,
             timed_steps: int = 8, repeats: int = 2, seed: int = 0,
             measure_timeout_s: Optional[float] = None,
             measure_retries: int = 2, device="cuda",
             trace_dir: Optional[str] = None, argv: str = "",
             constants: Optional[Tuple[float, float, float]] = None,
             include: Sequence[str] = ()) -> Dict[str, Any]:
    """The whole tuning loop; returns the evidence document.

    The first topology is the decision target (its shortlist is measured
    and its winner stamped), the rest get static rankings. ``include``
    names candidates of the target to measure besides its shortlist (each
    must pass the static funnel, flow audit included). ``device`` is the
    measuring device (default: the card). ``constants``: other
    bandwidths for the cost model (:func:`.cost.projection_constants`).
    ``ok`` is the command line's exit-0 condition: a static run is ok, a
    measured one needs a winner whose overlap sandwich holds."""
    specs = [t if isinstance(t, TuneTopology) else TuneTopology.parse(t)
             for t in topologies]
    if not specs:
        raise ValueError("at least one topology is required")
    target = specs[0]
    structs = model_structs(model)
    ici_bw, dcn_bw, wan_bw, projection = projection_constants(constants)

    static: Dict[str, Any] = {}
    by_name: Dict[str, Candidate] = {}
    traces: Dict[str, Any] = {}
    for spec in specs:
        cands = enumerate_candidates(spec)
        for c in cands:
            by_name.setdefault(c.name, c)
        static[spec.label] = static_prune(
            cands, spec, structs, audit_world=audit_world,
            shortlist_n=shortlist_n, constants=constants,
            include=include if spec is target else (),
            traces=traces if spec is target else None)

    doc: Dict[str, Any] = {
        "tool": "grace_tpu_torch.tuning",
        "model": model,
        "topologies": [{"world": s.world, "slice_size": s.slice_size,
                        "region_size": s.region_size, "label": s.label}
                       for s in specs],
        "target": target.label,
        "cost_model": {
            "ici_bytes_per_s": ici_bw, "dcn_bytes_per_s": dcn_bw,
            "wan_bytes_per_s": wan_bw,
            "rule": "projected_step = base_compute_step + ici_bytes/ICI_BW"
                    " + dcn_bytes/DCN_BW + wan_bytes/WAN_BW (per-link "
                    "recv_link_bytes under the target Topology; see "
                    "grace_tpu_torch/tuning/cost.py)",
            "constants_source": projection["constants_source"],
        },
        "static": static,
        "static_only": bool(static_only),
        "ok": True,
    }

    if not static_only:
        target_prune = static[target.label]
        with measuring_group(device) as (group, dev):
            measured = measure_shortlist(
                [by_name[n] for n in target_prune["shortlist"]], target,
                group, model=model, timed_steps=timed_steps,
                repeats=repeats, seed=seed,
                measure_timeout_s=measure_timeout_s,
                measure_retries=measure_retries, device=dev,
                constants=constants)
            doc["measured"] = measured
            winner = measured["winner"]
            sandwich = None
            if winner is not None:
                if trace_dir is not None:
                    os.makedirs(trace_dir, exist_ok=True)
                with (tempfile.TemporaryDirectory(prefix="grace_tune_prof_")
                      if trace_dir is None
                      else contextlib.nullcontext(trace_dir)) as tdir:
                    sandwich = overlap_sandwich(
                        by_name[winner], traces[winner], tdir, group,
                        model=model, seed=seed, device=dev)
        if winner is None:
            doc["ok"] = False
            doc["error"] = "no shortlisted candidate produced a measurement"
        else:
            rec = next(r for r in target_prune["funnel"]
                       if r["candidate"] == winner)
            doc["winner"] = {
                "candidate": winner,
                # grace_from_params(grace_params) rebuilds the winner.
                "grace_params": dict(by_name[winner].params),
                "topology": {"world": target.world,
                             "slice_size": target.slice_size},
                "predicted": rec.get("predicted"),
                "static_overlap_bound":
                    (rec.get("flow") or {}).get("overlap_bound"),
                "measured": next(r for r in measured["rows"]
                                 if r["candidate"] == winner),
                "overlap_sandwich": sandwich,
            }
            doc["ok"] = bool(sandwich["holds"])

    # Provenance last: everything above is deterministic for one registry
    # and topology, but for these stamps.
    from grace_tpu_torch.utils.logging import run_provenance
    doc["provenance"] = run_provenance(data="synthetic",
                                       tool="grace_tpu_torch.tuning",
                                       argv=argv)
    doc["captured_at"] = datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")
    return doc


def write_tune_evidence(doc: Dict[str, Any],
                        path: str = TUNE_EVIDENCE_PATH,
                        ledger_path: Optional[str] = None) -> None:
    """Write ``doc`` atomically (a temporary file, fsync, replace) and
    record its winner as ``tune-winner`` in the evidence ledger: the
    port's ledger for the default path, ``ledger_path`` when given, and
    none for another path without one (a test's file must not reach the
    port's ledger). On the card the record's ``chip`` is the card's name
    and power limit (``nvidia-smi``)."""
    from grace_tpu_torch.evidence.ledger import write_json_atomic

    write_json_atomic(path, doc)
    if ledger_path is None and (os.path.abspath(path)
                                != os.path.abspath(TUNE_EVIDENCE_PATH)):
        return
    from grace_tpu_torch.evidence.ledger import (LEDGER_PATH, card_chip,
                                                 record_artifact)
    prov = doc.get("provenance") or {}
    winner = doc.get("winner") or {}
    n_dev = prov.get("n_devices")
    platform = prov.get("platform")
    record_artifact(
        path, id="tune-winner", metric="tune_winner_config",
        value=winner.get("candidate"), claim_class="measured",
        tool="grace_tpu_torch.tuning", platform=platform,
        chip=((card_chip() or prov.get("device")) if platform == "gpu"
              else prov.get("device")),
        n_devices=n_dev,
        topology={"world": n_dev, "tiers": ["ici"], "slice": None,
                  "region": None},
        config=winner.get("grace_params"),
        lint_clean=bool(doc.get("ok")),
        ledger_path=ledger_path or LEDGER_PATH)
