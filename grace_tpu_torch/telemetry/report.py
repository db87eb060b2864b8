"""The report of one telemetry run log; the port's counterpart of the
repository's ``tools/telemetry_report.py``, with its flags, its text, its
``--json`` document and its exit codes.

Input: a file written by :class:`~grace_tpu_torch.telemetry.JSONLSink`, a
provenance header line followed by the per-step metric rows
(:class:`~grace_tpu_torch.telemetry.TelemetryReader`) and the event
records (guard transitions, watch summaries and anomalies, ``perf_*``,
``lint_finding``, ``adapt_*``, ``retune_*``).

:func:`render` gives the provenance block, a per-metric table (count,
mean, min, max, last over the rows), the wire traffic with the
dense-fallback windows read from the ``fallback`` flag, the adapt and
retune trails (:func:`render_adapt`, :func:`render_retune`), the watch,
profiling and static-analysis sections, and the guard event log;
:func:`build_doc` the same content as one JSON document. Standard library
only: it reads a file on any host, with no torch and no card.

Run::

    python -m grace_tpu_torch.telemetry run.jsonl
    python -m grace_tpu_torch.telemetry run.jsonl --metrics grad_norm,wire_bytes
    python -m grace_tpu_torch.telemetry run.jsonl --json

Exit status: 0 when the file holds a row or an event, 1 when it holds
neither.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

__all__ = ["PREFERRED", "load", "stats", "fallback_windows", "render",
           "render_adapt", "render_retune", "render_trails", "render_watch",
           "render_lint", "render_perf", "build_doc", "main"]

PROG = "python -m grace_tpu_torch.telemetry"

# Metric columns in display order; any other numeric field of the rows
# follows them.
PREFERRED = ["grad_norm", "update_norm", "residual_norm", "residual_max",
             "compression_error", "wire_bytes", "wire_bytes_ici",
             "wire_bytes_dcn", "dense_bytes", "fallback", "audit_bytes",
             "watch_bytes", "negotiation_bytes", "adapt_rung",
             "adapt_bytes"]


def load(path: str):
    """``(provenance, records, events)`` of one JSONL file; a line that is
    not JSON is reported on stderr and skipped."""
    provenance, records, events = None, [], []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                print(f"[{PROG}] {path}:{lineno}: bad JSON ({e}); skipping",
                      file=sys.stderr)
                continue
            if "provenance" in obj and provenance is None:
                provenance = obj["provenance"]
            elif "event" in obj:
                events.append(obj)
            else:
                records.append(obj)
    return provenance, records, events


def stats(values: List[float]) -> dict:
    return {"count": len(values),
            "mean": sum(values) / len(values),
            "min": min(values),
            "max": max(values),
            "last": values[-1]}


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return f"{int(v):>12,d}"
    return f"{v:>12.6g}"


def fallback_windows(records: List[dict]) -> List[tuple]:
    """``[(first_step, last_step), ...]`` of the runs of rows with
    ``fallback`` set."""
    windows, start, prev = [], None, None
    for rec in records:
        if rec.get("fallback"):
            if start is None:
                start = rec["step"]
            prev = rec["step"]
        elif start is not None:
            windows.append((start, prev))
            start = None
    if start is not None:
        windows.append((start, prev))
    return windows


def _is_perf(e: dict) -> bool:
    return str(e.get("event", "")).startswith("perf_")


def _is_adapt(e: dict) -> bool:
    return str(e.get("event", "")).startswith("adapt")


def _is_retune(e: dict) -> bool:
    return str(e.get("event", "")).startswith("retune")


def _is_watch(e: dict) -> bool:
    return e.get("event") in ("watch", "watch_anomaly")


def _is_lint(e: dict) -> bool:
    return e.get("event") == "lint_finding"


def _is_guard_log(e: dict) -> bool:
    """An event of the guard log: any record no other section reads."""
    return not (_is_perf(e) or _is_watch(e) or _is_lint(e) or _is_adapt(e)
                or _is_retune(e))


def _render_wire(records: List[dict]) -> List[str]:
    """The wire traffic: bytes received against the dense bytes, the
    per-link split and the dense-fallback windows."""
    wire = [float(r["wire_bytes"]) for r in records if "wire_bytes" in r]
    dense = [float(r["dense_bytes"]) for r in records if "dense_bytes" in r]
    if not (wire and dense):
        return []
    out = ["", "== wire traffic ==",
           f"  effective bytes received per rank, total: "
           f"{int(sum(wire)):,d} (raw dense gradient bytes "
           f"{int(sum(dense)):,d}; ratio "
           f"{sum(wire) / max(sum(dense), 1):.4f} — "
           "communicator-aware, so allgather at scale can "
           "legitimately exceed 1.0)"]
    ici = [float(r["wire_bytes_ici"]) for r in records
           if "wire_bytes_ici" in r]
    dcn = [float(r["wire_bytes_dcn"]) for r in records
           if "wire_bytes_dcn" in r]
    wan = [float(r.get("wire_bytes_wan", 0.0)) for r in records
           if "wire_bytes_ici" in r]
    if ici and dcn:
        tot = sum(ici) + sum(dcn) + sum(wan)
        wan_part = f", wan {int(sum(wan)):,d} B" if sum(wan) else ""
        out.append(
            f"  per-link split: ici {int(sum(ici)):,d} B, "
            f"dcn {int(sum(dcn)):,d} B{wan_part} "
            f"({100.0 * sum(dcn) / max(tot, 1):.1f}% over DCN, "
            f"{100.0 * sum(wan) / max(tot, 1):.1f}% over WAN — "
            "flat communicators bill everything at the worst "
            "tier they cross; a mixed split means a "
            "hierarchical schedule)")
    wins = fallback_windows(records)
    if wins:
        spans = ", ".join(f"{a}..{b}" for a, b in wins)
        out.append(f"  dense-fallback windows (recorded steps): {spans}")
    else:
        out.append("  dense-fallback windows: none")
    out.append("  (logical payload bytes — XLA may pad/repack on "
               "the wire; treat as the algorithmic lower bound, "
               "see grace_tpu/utils/metrics.py)")
    return out


def render(provenance, records, events,
           metrics: Optional[List[str]] = None) -> str:
    """The text report of one run (module docstring), line for line the
    repository tool's."""
    out = ["== provenance =="]
    if provenance:
        for k, v in provenance.items():
            out.append(f"  {k}: {v}")
    else:
        out.append("  (no provenance header — was this file written by "
                   "JSONLSink?)")

    out.append("")
    out.append(f"== per-step metrics ({len(records)} records) ==")
    if records:
        steps = [r["step"] for r in records if "step" in r]
        if steps:
            out.append(f"  steps {min(steps)}..{max(steps)}")
        dropped = sum(r.get("dropped_steps", 0) for r in records)
        if dropped:
            out.append(f"  ring-wraparound dropped rows: {dropped} "
                       "(flush interval exceeded telemetry capacity)")
        numeric = [k for k in records[-1]
                   if isinstance(records[-1][k], (int, float))
                   and not isinstance(records[-1][k], bool)
                   and k != "step"]
        cols = [m for m in (metrics or PREFERRED)
                if any(m in r for r in records)]
        cols += [k for k in sorted(numeric)
                 if k not in cols and metrics is None]
        out.append(f"  {'metric':<24s}{'count':>8s}" + "".join(
            f"{h:>13s}" for h in ("mean", "min", "max", "last")))
        for m in cols:
            vals = [float(r[m]) for r in records if m in r]
            if not vals:
                continue
            s = stats(vals)
            out.append(f"  {m:<24s}{s['count']:>8d}"
                       + "".join(" " + _fmt(s[k])
                                 for k in ("mean", "min", "max", "last")))
        out.extend(_render_wire(records))
        guard_keys = sorted(k for k in records[-1] if k.startswith("guard_"))
        if guard_keys:
            out.append("")
            out.append("== guard counters (at last flush) ==")
            for k in guard_keys:
                out.append(f"  {k}: {records[-1][k]}")
    else:
        out.append("  (none)")

    perf = [e for e in events if _is_perf(e)]
    watch = [e for e in events if _is_watch(e)]
    lint = [e for e in events if _is_lint(e)]
    other = [e for e in events if _is_guard_log(e)]
    out.extend(render_trails(records, events))
    if watch:
        out.append("")
        out.append("== watch (graft-watch summaries + anomalies) ==")
        out.extend(render_watch(watch))
    if perf:
        out.append("")
        out.append("== profiling (ProfileRecorder perf_* records) ==")
        out.extend(render_perf(perf))
    if lint:
        out.append("")
        out.append(f"== static analysis ({len(lint)} lint_finding "
                   "event(s)) ==")
        out.extend(render_lint(lint))

    out.append("")
    out.append(f"== guard events ({len(other)}) ==")
    for e in other:
        extras = {k: v for k, v in e.items() if k not in ("event", "step")}
        brief = ", ".join(f"{k}={v}" for k, v in sorted(extras.items())
                          if isinstance(v, (int, float, bool)))
        out.append(f"  step {e.get('step', '?'):>6}: {e['event']}"
                   + (f"  ({brief})" if brief else ""))
    if not other:
        out.append("  (none)")
    return "\n".join(out)


def render_adapt(adapt: List[dict], records: List[dict]) -> List[str]:
    """The ladder's trail: the rung range and dwell over the recorded
    steps, then one line per tighten/loosen transition."""
    out = []
    rungs = [(r["step"], int(r["adapt_rung"])) for r in records
             if "adapt_rung" in r and float(r["adapt_rung"]) >= 0
             and "step" in r]
    if rungs:
        lo = min(v for _, v in rungs)
        hi = max(v for _, v in rungs)
        out.append(f"  rung range over {len(rungs)} recorded steps: "
                   f"{lo}..{hi} (0 = dense escape; last "
                   f"{rungs[-1][1]} at step {rungs[-1][0]})")
        counts: dict = {}
        for _, v in rungs:
            counts[v] = counts.get(v, 0) + 1
        dwell = ", ".join(f"rung {k}: {v}" for k, v in sorted(counts.items()))
        out.append(f"  dwell (steps per effective rung): {dwell}")
    tightens = [e for e in adapt if e.get("event") == "adapt_tighten"]
    loosens = [e for e in adapt if e.get("event") == "adapt_loosen"]
    out.append(f"  transitions: {len(tightens)} tighten(s), "
               f"{len(loosens)} loosen(s)")
    for e in adapt:
        out.append(f"    step {e.get('step', '?'):>6}: {e['event']} "
                   f"rung {e.get('from_rung', '?')} -> {e.get('rung', '?')}")
    if not adapt and not rungs:
        out.append("  (controller armed but no rows recorded)")
    return out


def render_retune(retune: List[dict]) -> List[str]:
    """The retune trail: the tally of promotions, demotions, aborts and
    bounded-leg timeouts, one line per event, and the surviving
    configuration (a demotion inside probation is the rollback working)."""
    out = []
    promotes = [e for e in retune if e.get("event") == "retune_promote"]
    demotes = [e for e in retune if e.get("event") == "retune_demote"]
    timeouts = [e for e in retune if e.get("event") == "retune_timeout"]
    aborts = [e for e in retune if e.get("event") == "retune_abort"]
    out.append(f"  transactions: {len(promotes)} promotion(s), "
               f"{len(demotes)} demotion(s), {len(aborts)} abort(s), "
               f"{len(timeouts)} bounded-leg timeout(s)")
    for e in retune:
        name = str(e.get("event", "?"))
        extras = {k: v for k, v in e.items() if k not in ("event", "step")}
        brief = ", ".join(f"{k}={v}" for k, v in sorted(extras.items())
                          if isinstance(v, (int, float, bool, str))
                          and k not in ("reason",))
        out.append(f"    step {e.get('step', '?'):>6}: {name}"
                   + (f"  ({brief})" if brief else ""))
        if e.get("reason"):
            msg = str(e["reason"])
            out.append(f"            {msg[:150]}"
                       + ("…" if len(msg) > 150 else ""))
    closers = [e for e in retune
               if e.get("event") in ("retune_promote", "retune_demote")]
    if closers:
        last = closers[-1]
        survivor = (last.get("new") if last["event"] == "retune_promote"
                    else last.get("config"))
        out.append(f"  surviving config: {survivor}")
    return out


def render_trails(records: List[dict], events: List[dict]) -> List[str]:
    """The adapt and retune sections of one run, each under its heading,
    each only when the run has it."""
    adapt = [e for e in events if _is_adapt(e)]
    retune = [e for e in events if _is_retune(e)]
    out: List[str] = []
    if adapt or any("adapt_rung" in r and float(r["adapt_rung"]) >= 0
                    for r in records):
        out.append("")
        out.append("== adapt (graft-adapt rung transitions) ==")
        out.extend(render_adapt(adapt, records))
    if retune:
        out.append("")
        out.append("== retune (graft-retune config transactions) ==")
        out.extend(render_retune(retune))
    return out


def render_watch(watch: List[dict]) -> List[str]:
    """The cross-rank summaries (the window count, the worst skew, the
    last window's means) and the anomaly findings."""
    out = []
    summaries = [e for e in watch if e["event"] == "watch"]
    anomalies = [e for e in watch if e["event"] == "watch_anomaly"]
    if summaries:
        out.append(f"  {len(summaries)} cross-rank summaries "
                   f"(steps {summaries[0].get('step', '?')}"
                   f"..{summaries[-1].get('step', '?')})")
        worst = max(summaries, key=lambda e: e.get("skew_max", 0.0))
        out.append(
            f"  worst compression-error skew: {worst.get('skew_max', 0):.4g}"
            f" (rank {worst.get('skew_rank', '?')} at step "
            f"{worst.get('step', '?')}; relative to the cross-rank mean)")
        last = summaries[-1]
        for metric in ("grad_norm", "compression_error", "residual_norm"):
            mean = last.get(f"{metric}_mean")
            lo, hi = last.get(f"{metric}_min"), last.get(f"{metric}_max")
            if mean is None:
                continue
            out.append(f"  last window {metric}: mean {mean:.6g} "
                       f"(cross-rank min {lo:.6g} / max {hi:.6g})")
    if anomalies:
        out.append(f"  ANOMALIES ({len(anomalies)}):")
        for a in anomalies:
            rank = a.get("rank", -1)
            who = (f"rank {rank}" if isinstance(rank, int) and rank >= 0
                   else "fleet-wide")
            out.append(
                f"    step {a.get('step', '?'):>6}: "
                f"{a.get('kind', '?')}/{a.get('metric', '?')} ({who}) "
                f"score {a.get('score', 0):.3g} "
                f"threshold {a.get('threshold', 0):.3g} "
                f"value {a.get('value', 0):.4g}")
    else:
        out.append("  anomalies: none")
    return out


def render_lint(lint: List[dict]) -> List[str]:
    """The auditor's ``lint_finding`` records, one finding a line with its
    stage, then its message."""
    out = []
    for e in lint:
        loc = str(e.get("config", "?"))
        if e.get("stage"):
            loc += f" [{e['stage']}]"
        out.append(f"  {str(e.get('severity', '?')).upper():7s} "
                   f"{str(e.get('pass', '?')):24s} {loc}")
        msg = str(e.get("message", ""))
        out.append(f"          {msg[:160]}" + ("…" if len(msg) > 160 else ""))
    return out


def render_perf(perf: List[dict]) -> List[str]:
    """The step-time percentiles (the last record: they are cumulative),
    compile and retrace events, the memory watermark and the footprint
    check."""
    out = []
    times = [e for e in perf if e["event"] == "perf_step_times"]
    if times:
        t = times[-1]
        order = ["mean_ms", "p50_ms", "p90_ms", "p99_ms", "max_ms"]
        keys = [k for k in order if k in t] + \
            [k for k in sorted(t) if k.endswith("_ms") and k not in order]
        pcts = ", ".join(f"{k[:-3]} {t[k]:.3f}" for k in keys)
        out.append(f"  step times (n={t.get('n_steps', '?')}): {pcts} ms")
        if t.get("sync_missing"):
            out.append("  WARNING: timed without sync_on() — these are "
                       "async-dispatch times, not step times")
        if t.get("failed_steps"):
            out.append(f"  failed steps recorded: {t['failed_steps']}")
    compiles = [e for e in perf if e["event"] == "perf_compile"]
    retraces = [e for e in perf if e["event"] == "perf_retrace"]
    if compiles or retraces:
        steps = ", ".join(str(e.get("step", "?")) for e in retraces)
        out.append(f"  compiles observed: {len(compiles)}; retraces: "
                   f"{len(retraces)}"
                   + (f" at step(s) {steps} — the step function recompiled "
                      "mid-run (weak-type/shape leak into carried state; "
                      "see graft-lint signature_stability)"
                      if retraces else ""))
    mems = [e for e in perf if e["event"] == "perf_memory"]
    if mems:
        m = mems[-1]
        peak = m.get("peak_bytes_in_use")
        cur = m.get("bytes_in_use")
        bits = []
        if peak is not None:
            bits.append(f"peak {peak:,d} B")
        if cur is not None:
            bits.append(f"in use {cur:,d} B")
        out.append(f"  device memory watermark (max over "
                   f"{m.get('n_devices', '?')} devices): "
                   + ", ".join(bits))
    feet = [e for e in perf if e["event"] == "perf_state_footprint"]
    if feet:
        f = feet[-1]
        out.append(
            f"  GraceState footprint: mem {f.get('mem_bytes', 0):,d} B, "
            f"comp {f.get('comp_bytes', 0):,d} B, "
            f"telem {f.get('telem_bytes', 0):,d} B")
        if "footprint_matches" in f:
            out.append("  footprint vs codec model: "
                       + ("matches" if f["footprint_matches"] else
                          "MISMATCH — live state was built under a "
                          "different config than reported"))
    if not out:
        out.append("  (perf records present but empty)")
    return out


def build_doc(provenance, records, events,
              metrics: Optional[List[str]] = None) -> dict:
    """The ``--json`` document: what :func:`render` shows, as data."""
    numeric = sorted({k for r in records for k, v in r.items()
                      if isinstance(v, (int, float))
                      and not isinstance(v, bool) and k != "step"})
    cols = [m for m in (metrics or PREFERRED)
            if any(m in r for r in records)]
    cols += [k for k in numeric if k not in cols and metrics is None]
    table = {}
    for m in cols:
        vals = [float(r[m]) for r in records if m in r]
        if vals:
            table[m] = stats(vals)
    steps = [r["step"] for r in records if "step" in r]
    return {
        "provenance": provenance,
        "records": len(records),
        "step_span": [min(steps), max(steps)] if steps else None,
        "dropped_steps": sum(r.get("dropped_steps", 0) for r in records),
        "metrics": table,
        "fallback_windows": [list(w) for w in fallback_windows(records)],
        "guard_counters": ({k: records[-1][k] for k in sorted(records[-1])
                            if k.startswith("guard_")} if records else {}),
        "watch_summaries": [e for e in events if e.get("event") == "watch"],
        "watch_anomalies": [e for e in events
                            if e.get("event") == "watch_anomaly"],
        "perf_events": [e for e in events if _is_perf(e)],
        "lint_findings": [e for e in events if _is_lint(e)],
        "adapt_events": [e for e in events if _is_adapt(e)],
        "retune_events": [e for e in events if _is_retune(e)],
        "guard_events": [e for e in events if _is_guard_log(e)],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("path", help="telemetry JSONL file (JSONLSink output)")
    ap.add_argument("--metrics", default=None,
                    help="comma-separated metric subset to summarize")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-readable JSON document instead "
                         "of the text report")
    args = ap.parse_args(argv)
    provenance, records, events = load(args.path)
    metrics = args.metrics.split(",") if args.metrics else None
    if args.json:
        print(json.dumps(build_doc(provenance, records, events, metrics),
                         indent=1))
    else:
        print(render(provenance, records, events, metrics))
    return 0 if (records or events) else 1
