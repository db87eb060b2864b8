"""``python -m grace_tpu_torch.analysis``: the static auditor's command
line (the counterpart of the JAX package's ``tools/graft_lint.py``).

Audits registry configs (``--config NAME``, ``--all-configs``; default:
the core subset) or an ad-hoc one (``--params JSON``), at ``--world W``
ranks, on the card's route (``--device cuda``, the default: no card is
needed) or the CPU's, over the default audit parameters or a model's
(``--model resnet50``: its 161 leaves). Prints the findings; ``--json
PATH`` writes them with each config's per-branch report (collectives,
received bytes against the wire model, kernel launches, host reads, card
syncs) and the state footprint model; ``--jsonl PATH`` appends them as
``lint_finding`` events that ``tools/telemetry_report.py`` renders.
``--rules`` runs the four AST repo rules (:mod:`.rules`) over the port's
source, alone or beside the configs a ``--config``/``--all-configs``/
``--params`` selects. Exits 1 when there is an error finding, 2 on a bad
argument.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time
from typing import List, Optional

# The registry's fast, representative subset (the JAX tool's default).
CORE_CONFIGS = ("none-allreduce", "topk-allgather", "signsgd-sign_allreduce",
                "topk-ring", "topk1pct_hier", "topk-escape-telemetry",
                "topk-guard-consensus")


def _report(entry, structs, world: int, device: str, rank: int = 0):
    """``(report, findings)`` of one config: the per-branch report, its
    wire and footprint models, and the findings."""
    from grace_tpu_torch.analysis.configs import audit_traces
    from grace_tpu_torch.analysis.passes import (collective_signature,
                                                 count_recv_bytes,
                                                 wire_model)

    t0 = time.perf_counter()
    traces, findings = audit_traces(entry, world=world, device=device,
                                    params=structs, rank=rank)
    out = {"seconds": time.perf_counter() - t0, "branches": {},
           "findings": [f.as_dict() for f in findings]}
    for t in traces:
        out["branches"][t.branch] = {
            "collectives": len(t.collectives),
            "signature": repr(collective_signature(t)),
            "recv_bytes": count_recv_bytes(t),
            "kernels": t.kernel_counts(),
            "host_reads": len(t.host_reads),
            "syncs": len(t.syncs),
            "sync_sites": sorted({n.attrs.get("site", n.name)
                                  for n in t.syncs})}
    if traces and entry.get("mode", "update") == "update":
        base = traces[0]
        out["model_bytes"] = int(wire_model(base)[1])
        out["footprint_model"] = base.meta.get("footprint_model_world")
        out["state_tensors"] = sum(1 for _p, sig in base.state_in
                                   if len(sig) == 3)
    return out, findings


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m grace_tpu_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--all-configs", action="store_true",
                    help="audit the whole registry")
    ap.add_argument("--config", action="append", default=[],
                    help="audit the named registry config(s)")
    ap.add_argument("--params", default=None,
                    help="audit an ad-hoc config: its params as JSON")
    ap.add_argument("--mode", choices=("update", "train"), default="update",
                    help="the ad-hoc config's trace (default update)")
    ap.add_argument("--guard", default=None, metavar="JSON",
                    help="train mode: guarded_chain's keyword arguments "
                         "(the ad-hoc config's consensus param arms the "
                         "audit)")
    ap.add_argument("--passes", default=None,
                    help="comma-separated pass subset")
    ap.add_argument("--world", type=int, default=8,
                    help="world size to trace at (default 8)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="the route to trace (default cuda: the kernels' "
                         "fake launches; no card needed)")
    ap.add_argument("--model", choices=("default", "resnet50"),
                    default="default",
                    help="the parameters to trace over (default: the "
                         "audit's own two leaves)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the findings and per-config reports here")
    ap.add_argument("--jsonl", default=None, metavar="PATH",
                    help="append the findings as lint_finding events")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank to trace as (default 0; the state "
                         "passes compare it with the other end's)")
    ap.add_argument("--rules", action="store_true",
                    help="run the AST repo rules; alone unless configs "
                         "are selected too")
    ap.add_argument("--shard", default=None, metavar="I/N",
                    help="audit every N-th selected config from the I-th "
                         "(0-based): N processes together audit them all")
    args = ap.parse_args(argv)

    from grace_tpu_torch.analysis.configs import (AUDIT_CONFIGS,
                                                  model_param_structs)
    from grace_tpu_torch.analysis.passes import PASS_NAMES
    from grace_tpu_torch.analysis.report import render_text, write_jsonl

    by_name = {e["name"]: e for e in AUDIT_CONFIGS}
    if args.rules and not (args.params or args.config or args.all_configs):
        configs = []
    elif args.params:
        params = json.loads(args.params)
        configs = [{"name": "adhoc", "params": params, "passes": PASS_NAMES,
                    "mode": args.mode,
                    "guard": json.loads(args.guard) if args.guard else None,
                    "consensus": params.get("consensus")}]
    elif args.config:
        unknown = [n for n in args.config if n not in by_name]
        if unknown:
            print(f"unknown config(s) {unknown}",
                  file=sys.stderr)
            return 2
        configs = [by_name[n] for n in args.config]
    elif args.all_configs:
        configs = list(AUDIT_CONFIGS)
    else:
        configs = [by_name[n] for n in CORE_CONFIGS]
    if args.passes:
        selected = tuple(p.strip() for p in args.passes.split(",")
                         if p.strip())
        unknown = [p for p in selected if p not in PASS_NAMES]
        if unknown:
            print(f"unknown pass(es) {unknown}; registered: "
                  f"{', '.join(PASS_NAMES)}", file=sys.stderr)
            return 2
        configs = [dict(e, passes=tuple(p for p in e["passes"]
                                        if p in selected)) for e in configs]
        configs = [e for e in configs if e["passes"]]
    if args.shard:
        i, n = (int(v) for v in args.shard.split("/"))
        if not 0 <= i < n:
            print(f"--shard {args.shard}: need 0 <= I < N", file=sys.stderr)
            return 2
        configs = configs[i::n]
    # None: the audit's own parameters (and, in train mode, its model).
    structs = (None if args.model == "default"
               else model_param_structs(args.model))
    findings, reports = [], {}
    t0 = time.perf_counter()
    rules_checked = 0
    if args.rules:
        from grace_tpu_torch.analysis.rules import RULE_NAMES, run_repo_rules
        findings += run_repo_rules()
        rules_checked = len(RULE_NAMES)
    for entry in configs:
        print(f"[analysis] tracing {entry['name']}", file=sys.stderr,
              flush=True)
        reports[entry["name"]], found = _report(entry, structs, args.world,
                                                args.device, args.rank)
        findings += found
    print(render_text(findings, audited=len(configs),
                      rules_checked=rules_checked))
    errors = sum(1 for f in findings if f.severity == "error")
    if args.json:
        doc = {"tool": "grace_tpu_torch.analysis", "errors": errors,
               "warnings": len(findings) - errors,
               "configs_audited": len(configs),
               "rules_checked": rules_checked, "world": args.world,
               "rank": args.rank,
               "device": args.device, "model": args.model,
               "seconds": time.perf_counter() - t0,
               "passes_run": sorted({p for e in configs
                                     for p in e["passes"]}),
               "configs": reports,
               "findings": [f.as_dict() for f in findings],
               "captured_at": datetime.datetime.now(
                   datetime.timezone.utc).isoformat(timespec="seconds")}
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1, default=str)
            f.write("\n")
    if args.jsonl:
        write_jsonl(findings, args.jsonl,
                    provenance={"tool": "grace_tpu_torch.analysis",
                                "world": args.world,
                                "device": args.device})
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
