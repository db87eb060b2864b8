"""``python -m grace_tpu_torch.profiling --trace PATH``: the performance
attribution of a saved profiler trace; the port's counterpart of the
repository's ``tools/perf_report.py``, with its flags, text, document and
exit codes.

It renders what :func:`~grace_tpu_torch.profiling.analyze_trace` reads
from a ``torch.profiler`` Chrome trace (a ``*.trace.json[.gz]`` file or a
directory, whose newest capture wins; the JAX package's Chrome fixture
reads too): the per-stage device time over the ``grace/...`` vocabulary
(summing exactly to the total), the compute and collective split, the
overlap fraction, and the step-time percentiles.

* ``--baseline FILE`` gates against a stored baseline
  (:func:`compare_to_baseline`; ``--write-baseline`` stores one, ``--rtol``
  sets the band);
* ``--overlap-config NAME`` holds the trace's measured overlap under the
  static bound of the registry entry ``NAME``
  (:func:`~grace_tpu_torch.analysis.configs.overlap_sandwich`), traced in
  a fresh process (the tracer owns a fake default process group);
* ``--out`` writes the ``PROF_LAST.json`` document (default: the
  gitignored ``grace_tpu_torch/PROF_LAST.json``, never the repository
  root's; ``--out ''`` writes none).

Host code only: it reads a saved trace with no card.

Exit status: 0 clean, 1 baseline regression or sandwich violation, 2
crash or unknown config.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys

__all__ = ["DEFAULT_RTOL", "STAGE_ATOL_MS", "OVERLAP_ATOL", "DEFAULT_OUT",
           "compare_to_baseline", "baseline_view", "run_sandwich", "main"]

PROG = "python -m grace_tpu_torch.profiling"
PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(PKG_DIR, "PROF_LAST.json")

# The baseline gate's band: relative for times, absolute for the overlap
# fraction (already a ratio: a 5-point drop is collective time that became
# exposed). Improvements never fail.
DEFAULT_RTOL = 0.10
STAGE_ATOL_MS = 0.05          # stage jitter under 50 µs is ignored
OVERLAP_ATOL = 0.05


def compare_to_baseline(current: dict, baseline: dict,
                        rtol: float) -> list:
    """Regression findings of ``current`` (a ``TraceAnalysis.as_dict``)
    against a stored baseline of the same shape: times regress upward,
    the overlap fraction downward."""
    findings = []

    def worse(name, cur, base, atol=0.0):
        if cur is None or base is None:
            return
        if cur > base * (1.0 + rtol) + atol:
            findings.append(
                f"{name}: {cur:.3f} vs baseline {base:.3f} "
                f"(+{100.0 * (cur / base - 1.0) if base else 0.0:.1f}%, "
                f"tolerance {100.0 * rtol:.0f}%)")

    cur_steps = current.get("step_times") or {}
    base_steps = baseline.get("step_times") or {}
    worse("step p50 ms", cur_steps.get("p50_ms"), base_steps.get("p50_ms"))
    worse("step p99 ms", cur_steps.get("p99_ms"), base_steps.get("p99_ms"))
    worse("total device ms", current.get("total_device_ms"),
          baseline.get("total_device_ms"))
    for stage, base_ms in sorted((baseline.get("stages_ms") or {}).items()):
        worse(f"stage {stage} ms",
              (current.get("stages_ms") or {}).get(stage),
              base_ms, atol=STAGE_ATOL_MS)
    cur_ov = current.get("overlap_fraction")
    base_ov = baseline.get("overlap_fraction")
    if cur_ov is not None and base_ov is not None \
            and cur_ov < base_ov - OVERLAP_ATOL:
        findings.append(
            f"overlap fraction: {cur_ov:.3f} vs baseline {base_ov:.3f} "
            f"(collective time that used to hide under compute is now "
            f"exposed; tolerance {OVERLAP_ATOL:.2f} absolute)")
    return findings


def baseline_view(analysis_dict: dict) -> dict:
    """The comparable subset of an analysis (``--write-baseline``)."""
    return {
        "step_times": analysis_dict.get("step_times"),
        "total_device_ms": analysis_dict.get("total_device_ms"),
        "stages_ms": analysis_dict.get("stages_ms"),
        "overlap_fraction": analysis_dict.get("overlap_fraction"),
        "trace": analysis_dict.get("trace"),
        "captured_at": _now(),
    }


def _now() -> str:
    return datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")


# The sandwich's child: the entry by name (None when the registry has no
# such entry), traced at the default world on the card's route.
_SANDWICH_CHILD = """
import json, sys
from grace_tpu_torch.analysis.configs import AUDIT_CONFIGS, overlap_sandwich
entry = next((e for e in AUDIT_CONFIGS if e["name"] == sys.argv[1]), None)
print(json.dumps(None if entry is None
                 else overlap_sandwich(entry, json.loads(sys.argv[2]))))
"""


def run_sandwich(name: str, measured):
    """:func:`~grace_tpu_torch.analysis.configs.overlap_sandwich` of the
    registry entry ``name`` in a fresh interpreter; None for a name the
    registry does not hold."""
    out = subprocess.run(
        [sys.executable, "-c", _SANDWICH_CHILD, name, json.dumps(measured)],
        cwd=os.path.dirname(PKG_DIR), capture_output=True, text=True,
        timeout=600)
    if out.returncode:
        raise RuntimeError(f"the overlap child exited {out.returncode}: "
                           f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--trace", required=True,
                    help="profiler artifact (*.trace.json[.gz]) or a "
                         "profile directory (newest capture wins)")
    ap.add_argument("--baseline", default=None,
                    help="stored baseline JSON to gate against "
                         "(--write-baseline output)")
    ap.add_argument("--rtol", type=float, default=DEFAULT_RTOL,
                    help="relative tolerance of the baseline gate "
                         f"(default {DEFAULT_RTOL})")
    ap.add_argument("--write-baseline", default=None,
                    help="write the comparable metric subset to this path "
                         "and exit clean")
    ap.add_argument("--overlap-config", default=None,
                    help="registry config name (python -m "
                         "grace_tpu_torch.analysis --list) to sandwich the "
                         "trace's measured overlap fraction against: "
                         "measured must stay <= the static schedulability "
                         "bound (+slack) of that config's traced dataflow; "
                         "a violation exits 1")
    ap.add_argument("--json", action="store_true",
                    help="emit a JSON document instead of text")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="evidence document path ('' disables; default "
                         "grace_tpu_torch/PROF_LAST.json)")
    args = ap.parse_args(argv)

    from grace_tpu_torch.evidence.ledger import write_json_atomic
    from grace_tpu_torch.profiling.trace_analysis import analyze_trace

    analysis = analyze_trace(args.trace)
    doc = analysis.as_dict()
    if os.sep + os.path.join("tests", "data") + os.sep in \
            os.path.abspath(str(doc.get("trace") or "")):
        doc["note"] = ("canned CPU fixture trace — pipeline evidence, "
                       "not a chip capture")

    regressions = []
    if args.baseline:
        with open(args.baseline) as f:
            baseline = json.load(f)
        regressions = compare_to_baseline(doc, baseline, args.rtol)
        doc["baseline"] = args.baseline
        doc["baseline_rtol"] = args.rtol
        doc["regressions"] = regressions

    if args.overlap_config:
        sandwich = run_sandwich(args.overlap_config,
                                doc.get("overlap_fraction"))
        if sandwich is None:
            print(f"unknown config {args.overlap_config!r}; python -m "
                  "grace_tpu_torch.analysis --list shows the registry",
                  file=sys.stderr)
            return 2
        doc["overlap_sandwich"] = sandwich
        regressions = regressions + sandwich["violations"]

    if args.write_baseline:
        write_json_atomic(args.write_baseline, baseline_view(doc))
        print(f"[{PROG}] baseline -> {args.write_baseline}", file=sys.stderr)

    if args.out:
        evidence = {"tool": "grace_tpu_torch.profiling", **doc,
                    "captured_at": _now()}
        try:
            write_json_atomic(args.out, evidence)
        except OSError as e:
            print(f"[{PROG}] could not save {args.out}: {e}",
                  file=sys.stderr)

    if args.json:
        print(json.dumps(doc, indent=1))
    else:
        print(analysis.render())
        if args.overlap_config:
            s = doc["overlap_sandwich"]
            print()
            print(f"overlap sandwich vs {s['config']}: measured="
                  f"{s['measured_overlap']} <= static bound="
                  f"{s['static_overlap_bound']} (+{s['slack']} slack): "
                  + ("VIOLATED" if s["violations"] else "holds"))
        if args.baseline:
            print()
            if regressions:
                print(f"BASELINE REGRESSIONS ({len(regressions)}) vs "
                      f"{args.baseline}:")
                for r in regressions:
                    print(f"  REGRESSION {r}")
            else:
                print(f"baseline {args.baseline}: within tolerance "
                      f"(rtol {args.rtol})")
    return 1 if regressions else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:                                 # noqa: BLE001
        print(f"[{PROG}] crashed: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(2)
