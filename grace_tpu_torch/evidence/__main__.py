"""``python -m grace_tpu_torch.evidence``: the claim gate's command line;
the port's counterpart of the repository's ``tools/graft_gate.py``, with
its flags, report and exit codes.

Every quantitative claim line of the audited documents (``README.md`` and
``CHANGELOG.md`` under ``--root``, or each ``--doc``) must sit in a
paragraph with a claim marker (``<!-- evidence: <ledger-id> -->``), and
every cited record of the ledger must verify: its capture's hash
unchanged, its rev an ancestor of HEAD, its claim class consistent with
its device count
(:func:`~grace_tpu_torch.evidence.gate.gate_report`). Verdicts are
MEASURED, PROJECTED or STALE.

Run::

    python -m grace_tpu_torch.evidence                # report, exit 0
    python -m grace_tpu_torch.evidence --ci           # exit 1 on unmarked
                                                      # claims or STALE
    python -m grace_tpu_torch.evidence --root DIR --update-readme
    python -m grace_tpu_torch.evidence --backfill     # mint the port's
                                                      # committed artifacts
    python -m grace_tpu_torch.evidence --json

The ledger is the port's (``<root>/grace_tpu_torch/EVIDENCE/ledger.jsonl``,
gitignored) unless ``--ledger`` names another. ``--update-readme`` splices
the badge block into ``<root>/README.md`` and needs ``--root`` given: the
repository root's README is the JAX package's. Host code only, no torch.

Exit status: 0 gate passes (or report-only mode); 1 gate failures under
``--ci``; 2 crash or a bad argument.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

PROG = "python -m grace_tpu_torch.evidence"


def slim_report(report: dict) -> dict:
    """The ``--json`` document: the verdicts and failures, without the
    records' bodies and the claim lines."""
    return {
        "ok": report["ok"],
        "failures": report["failures"],
        "records": {cid: {"status": r["status"],
                          "failures": r["failures"],
                          "notes": r["notes"]}
                    for cid, r in report["records"].items()},
        "claims": {doc: {"n_claims": len(scan["claims"]),
                         "n_unmarked": len(scan["unmarked"])}
                   for doc, scan in report["docs"].items()},
    }


def render_report(report: dict) -> str:
    """The text report: claim counts a document, one line a cited record
    with its failures, and the gate's verdict."""
    out = []
    for doc, scan in sorted(report["docs"].items()):
        out.append(f"[graft_gate] {doc}: {len(scan['claims'])} "
                   f"quantitative claim line(s), "
                   f"{len(scan['unmarked'])} unmarked")
    for cid, res in sorted(report["records"].items()):
        rec = res.get("record") or {}
        out.append(f"  {res['status']:<9} {cid}  "
                   f"[{rec.get('claim_class', '?')}] "
                   f"{rec.get('metric', 'no-record')}")
        for f in res["failures"]:
            out.append(f"            ! {f}")
    if report["failures"]:
        out.append(f"[graft_gate] {len(report['failures'])} gate "
                   f"failure(s):")
        for f in report["failures"]:
            out.append(f"  FAIL {f}")
    else:
        out.append("[graft_gate] gate clean: every claim marked, every "
                   "citation verifies")
    return "\n".join(out)


def main(argv=None) -> int:
    from grace_tpu_torch.evidence.ledger import repo_root

    ap = argparse.ArgumentParser(prog=PROG,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--ci", action="store_true",
                    help="exit 1 on unmarked quantitative claims or "
                         "STALE citations")
    ap.add_argument("--update-readme", action="store_true",
                    help="splice the MEASURED/PROJECTED/STALE badge "
                         "block into <root>/README.md (needs --root)")
    ap.add_argument("--backfill", action="store_true",
                    help="mint ledger records for the port's committed "
                         "artifacts not yet in the ledger")
    ap.add_argument("--json", action="store_true",
                    help="print the full report as JSON")
    ap.add_argument("--root", default=None,
                    help="tree to audit (default: this repository)")
    ap.add_argument("--ledger", default=None,
                    help="ledger path (default: <root>/grace_tpu_torch/"
                         "EVIDENCE/ledger.jsonl)")
    ap.add_argument("--doc", action="append", default=None,
                    help="a document to audit, relative to --root or "
                         "absolute (repeatable; default README.md and "
                         "CHANGELOG.md)")
    args = ap.parse_args(argv)
    if args.update_readme and args.root is None:
        print(f"[{PROG}] --update-readme needs --root: the repository "
              "root's README.md is the JAX package's", file=sys.stderr)
        return 2
    root = args.root or repo_root()
    ledger = args.ledger or os.path.join(root, "grace_tpu_torch",
                                         "EVIDENCE", "ledger.jsonl")

    from grace_tpu_torch.evidence.backfill import backfill_ledger
    from grace_tpu_torch.evidence.gate import gate_report, splice_badges

    if args.backfill:
        appended = backfill_ledger(root, ledger, verbose=True)
        print(f"[graft_gate] backfill appended {len(appended)} record(s)")

    report = gate_report(root, ledger, **(
        {"docs": tuple(args.doc)} if args.doc else {}))

    if args.update_readme:
        changed = splice_badges(os.path.join(root, "README.md"), report)
        print(f"[graft_gate] README badge block "
              f"{'updated' if changed else 'unchanged'}")

    if args.json:
        print(json.dumps(slim_report(report), indent=1))
    else:
        print(render_report(report))
    return 1 if args.ci and not report["ok"] else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:                                 # noqa: BLE001
        print(f"[{PROG}] crashed: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(2)
