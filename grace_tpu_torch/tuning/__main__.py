"""``python -m grace_tpu_torch.tuning``: the tuner's command line (the
counterpart of the JAX package's ``tools/graft_tune.py``).

Enumerates candidates from the audited registry and generated variants,
prunes them statically (capability gates, numeric safety at the target
world, per-link wire pricing under the target topology, flow passes 5–7)
and, unless ``--static-only``, measures the shortlist with timed steps on
the card (``--device cpu`` on the CPU) and stamps the winner, gated by
the measured≤static overlap sandwich. ``--topology`` is ``W``,
``W,slice_size[,region_size]`` or ``DPxFSDP[,...]`` (repeatable; the first
is the decision target; default ``8`` and ``256,8``). The document goes to
``--out`` (default ``grace_tpu_torch/TUNE_LAST.json``; ``''``: none), its
winner as a ``tune-winner`` record to the port's evidence ledger for the
default ``--out``, or to ``--ledger PATH``.
Exits 0 when the document is ok, 1 when no candidate was measured or the
winner's sandwich fails, 2 on a bad argument.

    python -m grace_tpu_torch.tuning --static-only --topology 8
    python -m grace_tpu_torch.tuning --topology 8 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

# The default survey: one node of 8, and 32 nodes of 8.
DEFAULT_TOPOLOGIES = ("8", "256,8")


def render(doc: dict) -> str:
    """The document as text: each topology's funnel and head of the
    ranking, the measured rows and the winner."""
    out = []
    for label, st in doc["static"].items():
        c = st["counts"]
        out.append(f"== static ranking @ {label} (model={doc['model']}) ==")
        out.append(
            f"funnel: {c['enumerated']} enumerated -> "
            f"{c['capability_rejected']} capability-rejected, "
            f"{c['numeric_rejected']} numeric-rejected, "
            f"{c['degradation_rejected']} degradation-rejected -> "
            f"{c['priced']} priced -> {c['flow_rejected']} flow-rejected "
            f"-> {c['shortlisted']} shortlisted")
        for i, r in enumerate(st["ranking"][:10]):
            mark = "*" if r["verdict"] == "shortlisted" else " "
            out.append(
                f" {mark}{i + 1:2d}. {r['candidate']:38s} "
                f"proj {r['projected_step_ms']:.4f} ms  "
                f"x{r['predicted_speedup_vs_dense']} vs dense  "
                f"(ici {r['ici_bytes']:,} B / dcn {r['dcn_bytes']:,} B / "
                f"wan {r['wan_bytes']:,} B)")
        out.append(f" shortlist: {', '.join(st['shortlist'])}")
        out.append("")
    m = doc.get("measured")
    if m:
        out.append(f"== measured shortlist @ {doc['target']} "
                   f"(world={m['measured_world']}, {m['device']}, "
                   f"{m['repeats']}x{m['timed_steps']} steps) ==")
        for r in m["rows"]:
            out.append(
                f"  {r['candidate']:38s} measured "
                f"{r['measured_step_ms']:.3f} ms (dense "
                f"{r['baseline_step_ms']:.3f}) -> projected "
                f"{r['projected_step_ms']:.3f} ms at target; kernels "
                f"{r['launches'] or 'none'}")
        for s in m["skipped"]:
            out.append(f"  {s['candidate']:38s} SKIPPED: {s['reason']}")
        out.append("")
    w = doc.get("winner")
    if w:
        s = w["overlap_sandwich"]
        out.append(f"WINNER: {w['candidate']} @ {doc['target']}")
        out.append(f"  grace_from_params({json.dumps(w['grace_params'])})")
        out.append(
            f"  sandwich: measured={s['measured_overlap']} <= static "
            f"bound={s['static_overlap_bound']} (+{s['slack']}): "
            + ("holds" if s["holds"] else "VIOLATED"))
    if doc.get("error"):
        out.append(f"ERROR: {doc['error']}")
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m grace_tpu_torch.tuning",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--topology", action="append", default=[],
                    help="target as 'W', 'W,slice_size[,region_size]' or "
                         "'DPxFSDP[,...]' (repeatable; the first is the "
                         "decision target; default: "
                         + " and ".join(DEFAULT_TOPOLOGIES) + ")")
    ap.add_argument("--model", choices=("toy", "resnet50"), default="toy",
                    help="the parameters priced (and, for toy, measured)")
    ap.add_argument("--shortlist", type=int, default=3,
                    help="ranked survivors to measure (default 3)")
    ap.add_argument("--include", action="append", default=[],
                    help="a candidate of the target to measure besides the "
                         "shortlist (repeatable)")
    ap.add_argument("--static-only", action="store_true",
                    help="enumerate, prune and rank only; no timed steps")
    ap.add_argument("--timed-steps", type=int, default=8,
                    help="steps a timing window (default 8)")
    ap.add_argument("--repeats", type=int, default=2,
                    help="interleaved dense/candidate sample pairs "
                         "(default 2)")
    ap.add_argument("--audit-world", type=int, default=8,
                    help="ranks the flow audit traces at (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="the measuring device (default: the card)")
    ap.add_argument("--json", action="store_true",
                    help="print the document instead of text")
    ap.add_argument("--out", default=None,
                    help="where to write the document ('' : nowhere; "
                         "default grace_tpu_torch/TUNE_LAST.json)")
    ap.add_argument("--ledger", default=None,
                    help="the evidence ledger the winner is recorded in "
                         "(default: the port's, for the default --out)")
    args = ap.parse_args(argv)

    from grace_tpu_torch.tuning import (TUNE_EVIDENCE_PATH, run_tune,
                                        write_tune_evidence)

    try:
        doc = run_tune(tuple(args.topology) or DEFAULT_TOPOLOGIES,
                       model=args.model, shortlist_n=args.shortlist,
                       static_only=args.static_only,
                       audit_world=args.audit_world,
                       timed_steps=args.timed_steps, repeats=args.repeats,
                       device=args.device, include=tuple(args.include),
                       argv=" ".join(sys.argv[1:] if argv is None
                                     else argv))
    except ValueError as e:
        print(f"bad argument: {e}", file=sys.stderr)
        return 2
    out = TUNE_EVIDENCE_PATH if args.out is None else args.out
    if out:
        write_tune_evidence(doc, out, ledger_path=args.ledger)
    print(json.dumps(doc, indent=1) if args.json else render(doc))
    return 0 if doc.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
