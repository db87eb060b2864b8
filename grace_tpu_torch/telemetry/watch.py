"""The run timeline and anomaly report of one telemetry artifact, with its
regression gate; the port's counterpart of the repository's
``tools/graft_watch.py``, with its flags, text, document and exit codes.

Input: a JSONL artifact written by
:class:`~grace_tpu_torch.telemetry.JSONLSink` (metric rows, watch
summaries, ``watch_anomaly`` records, guard and consensus transitions,
``perf_*`` and ``lint_finding`` records in one stream).

* ``--timeline`` (the default view): the step-keyed timeline
  (:class:`~grace_tpu_torch.telemetry.timeline.Timeline`).
* ``--anomalies``: re-run the streaming detectors
  (:class:`~grace_tpu_torch.telemetry.anomaly.WatchMonitor`) over the
  artifact offline and list the recorded and the re-derived findings.
* ``--baseline FILE``: the regression gate of :func:`compare_to_baseline`
  against a summary stored by ``--write-baseline``.

``--out`` writes the ``WATCH_LAST.json`` document (default: the gitignored
``grace_tpu_torch/WATCH_LAST.json``, never the repository root's, which is
the JAX tool's; ``--out ''`` writes none). With ``--ledger PATH``, or when
``--out`` is the default, the document is recorded in the port's evidence
ledger (``watch-drill``). Standard library only, no torch.

Run::

    python -m grace_tpu_torch.telemetry.watch run.jsonl
    python -m grace_tpu_torch.telemetry.watch run.jsonl --anomalies
    python -m grace_tpu_torch.telemetry.watch run.jsonl --json
    python -m grace_tpu_torch.telemetry.watch run.jsonl --write-baseline B.json
    python -m grace_tpu_torch.telemetry.watch run.jsonl --baseline B.json

Exit status: 0 clean, 1 baseline regression, 2 crash.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys

__all__ = ["SCORE_RTOL", "DEFAULT_OUT", "compare_to_baseline",
           "baseline_view", "main"]

PROG = "python -m grace_tpu_torch.telemetry.watch"
PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(PKG_DIR, "WATCH_LAST.json")

# The gate's headroom on an anomaly kind's max score: a detector's score is
# already a ratio over its own threshold band, so growth beyond 25% over
# the baseline's worst episode is an escalation, not jitter.
SCORE_RTOL = 0.25


def _now() -> str:
    return datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")


def compare_to_baseline(current: dict, baseline: dict,
                        score_rtol: float = SCORE_RTOL) -> list:
    """Regression findings of a timeline summary against a stored one: a
    detector kind that fires where the baseline's never did, more often,
    or harder (max score beyond ``score_rtol``); guard, consensus or lint
    events that grow; and a first anomaly earlier than the baseline's."""
    findings = []
    cur_by = current.get("anomalies_by_kind") or {}
    base_by = baseline.get("anomalies_by_kind") or {}
    for kind in sorted(cur_by):
        cur_n, base_n = cur_by[kind], base_by.get(kind, 0)
        if cur_n > base_n:
            findings.append(
                f"anomaly kind '{kind}': {cur_n} event(s) vs baseline "
                f"{base_n}" + (" (new kind)" if base_n == 0 else ""))
    cur_scores = current.get("anomaly_max_score") or {}
    base_scores = baseline.get("anomaly_max_score") or {}
    for kind, cur_s in sorted(cur_scores.items()):
        base_s = base_scores.get(kind)
        if base_s and cur_s > base_s * (1.0 + score_rtol):
            findings.append(
                f"anomaly kind '{kind}': max score {cur_s:.3g} vs "
                f"baseline {base_s:.3g} (+{100 * (cur_s / base_s - 1):.0f}%"
                f", tolerance {100 * score_rtol:.0f}%)")
    cur_counts = current.get("kind_counts") or {}
    base_counts = baseline.get("kind_counts") or {}
    for kind in ("guard", "consensus", "lint"):
        cur_n, base_n = cur_counts.get(kind, 0), base_counts.get(kind, 0)
        if cur_n > base_n:
            findings.append(
                f"{kind} events: {cur_n} vs baseline {base_n} — the "
                "downstream resilience layer fired more than the baseline "
                "run")
    cur_first = current.get("first_anomaly_step")
    base_first = baseline.get("first_anomaly_step")
    if cur_first is not None and base_first is not None \
            and cur_first < base_first:
        findings.append(
            f"first anomaly at step {cur_first} vs baseline {base_first} "
            "— the run degrades earlier than it used to")
    return findings


def baseline_view(summary: dict) -> dict:
    """The comparable subset of a timeline summary (``--write-baseline``)."""
    return {
        "anomalies": summary.get("anomalies", 0),
        "anomalies_by_kind": summary.get("anomalies_by_kind") or {},
        "anomaly_max_score": summary.get("anomaly_max_score") or {},
        "kind_counts": summary.get("kind_counts") or {},
        "first_anomaly_step": summary.get("first_anomaly_step"),
        "captured_at": _now(),
    }


def _write_evidence(path: str, doc: dict, prov: dict, artifact: str,
                    ledger) -> None:
    """The ``WATCH_LAST.json`` document, stamped with the rev, the device
    count and the topology from the artifact's provenance, and its
    ``watch-drill`` ledger record when ``ledger`` names one."""
    from grace_tpu_torch.evidence.ledger import (git_head_rev,
                                                 record_artifact,
                                                 write_json_atomic)

    n_dev = prov.get("n_devices")
    rev = git_head_rev()
    stamped = {**doc, "git_rev": rev, "n_devices": n_dev,
               "topology": ({"world": n_dev, "tiers": ["ici"],
                             "slice": None, "region": None}
                            if n_dev else None),
               "captured_at": _now()}
    try:
        write_json_atomic(path, stamped)
    except OSError as e:
        print(f"[{PROG}] could not save {path}: {e}", file=sys.stderr)
        return
    if ledger:
        record_artifact(path, id="watch-drill", metric="watch_anomalies",
                        value=doc.get("anomalies"), claim_class="measured",
                        tool=doc["tool"], platform=prov.get("platform"),
                        chip=prov.get("device"), n_devices=n_dev,
                        topology=stamped["topology"], config=artifact,
                        lint_clean=None, git_rev=rev, ledger_path=ledger)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("path", help="telemetry JSONL artifact (JSONLSink "
                                 "output)")
    ap.add_argument("--timeline", action="store_true",
                    help="render the merged step-keyed timeline (default "
                         "when no other view is selected)")
    ap.add_argument("--anomalies", action="store_true",
                    help="re-run the streaming detectors offline and list "
                         "recorded + re-derived anomalies")
    ap.add_argument("--kinds", default=None,
                    help="comma-separated timeline kind filter "
                         "(telemetry,watch,anomaly,guard,consensus,perf,"
                         "lint,other)")
    ap.add_argument("--limit", type=int, default=60,
                    help="max timeline lines (0 = unlimited)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON document (summary + anomalies) "
                         "instead of text")
    ap.add_argument("--baseline", default=None,
                    help="stored baseline JSON to gate against "
                         "(--write-baseline output)")
    ap.add_argument("--write-baseline", default=None,
                    help="write the comparable summary subset to this "
                         "path")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="evidence document path ('' disables; default "
                         "grace_tpu_torch/WATCH_LAST.json)")
    ap.add_argument("--ledger", default=None,
                    help="record the evidence document in this ledger "
                         "(default: the port's ledger when --out is the "
                         "default path, else none)")
    args = ap.parse_args(argv)

    from grace_tpu_torch.telemetry.anomaly import WatchMonitor
    from grace_tpu_torch.telemetry.timeline import Timeline

    timeline = Timeline.from_jsonl(args.path)
    summary = timeline.summary()

    recorded = [e.record for e in timeline.anomalies()]
    derived = []
    if args.anomalies:
        # Every record but the recorded anomalies through a fresh monitor:
        # on a run with live detection it finds the same episodes again.
        derived = WatchMonitor().observe(
            e.record for e in timeline if e.kind != "anomaly")

    regressions = []
    if args.baseline:
        with open(args.baseline) as f:
            baseline = json.load(f)
        regressions = compare_to_baseline(summary, baseline)

    doc = {"tool": "grace_tpu_torch.telemetry.watch",
           "artifact": args.path, **summary,
           "recorded_anomalies": recorded}
    if args.anomalies:
        doc["derived_anomalies"] = derived
    if args.baseline:
        doc["baseline"] = args.baseline
        doc["regressions"] = regressions

    if args.write_baseline:
        from grace_tpu_torch.evidence.ledger import write_json_atomic
        write_json_atomic(args.write_baseline, baseline_view(summary))
        print(f"[{PROG}] baseline -> {args.write_baseline}", file=sys.stderr)

    if args.out:
        ledger = args.ledger
        if ledger is None and os.path.abspath(args.out) == DEFAULT_OUT:
            from grace_tpu_torch.evidence.ledger import LEDGER_PATH
            ledger = LEDGER_PATH
        _write_evidence(args.out, doc, timeline.provenance or {}, args.path,
                        ledger)

    if args.json:
        print(json.dumps(doc, indent=1))
        return 1 if regressions else 0
    kinds = tuple(args.kinds.split(",")) if args.kinds else None
    if args.timeline or not args.anomalies:
        print(timeline.render(kinds=kinds, limit=args.limit or None))
        print()
    if args.anomalies:
        print(f"== anomalies (recorded {len(recorded)}, re-derived "
              f"{len(derived)}) ==")
        # One episode once: a re-derived finding is the recorded one when
        # it names the same step, kind, metric and rank.
        def ident(a):
            return (a.get("step"), a.get("kind"), a.get("metric"),
                    a.get("rank"))
        known = {ident(a) for a in recorded}
        seen = recorded + [d for d in derived if ident(d) not in known]
        for a in seen:
            print(f"  step {a.get('step', '?'):>6}: "
                  f"{a.get('kind', '?')}/{a.get('metric', '?')} "
                  f"rank={a.get('rank', -1)} "
                  f"score={a.get('score', 0):.3g} "
                  f"value={a.get('value', 0):.4g}")
        if not seen:
            print("  (none)")
        print()
    counts = summary.get("kind_counts") or {}
    print("== summary ==")
    print("  " + ", ".join(f"{k}: {v}" for k, v in sorted(counts.items())))
    if summary.get("anomalous_ranks"):
        print(f"  anomalous ranks: {summary['anomalous_ranks']} "
              f"(first anomaly at step {summary.get('first_anomaly_step')})")
    if args.baseline:
        if regressions:
            print(f"\nBASELINE REGRESSIONS ({len(regressions)}) vs "
                  f"{args.baseline}:")
            for r in regressions:
                print(f"  REGRESSION {r}")
        else:
            print(f"\nbaseline {args.baseline}: within tolerance")
    return 1 if regressions else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:                                 # noqa: BLE001
        print(f"[{PROG}] crashed: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(2)
