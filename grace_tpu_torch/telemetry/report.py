"""The controllers' trails of a telemetry run log; the port's counterpart
of the adapt and retune sections of the repository's
``tools/telemetry_report.py``.

:func:`render_adapt` renders the adaptive ladder's rung trajectory (the
metric rows' ``adapt_rung`` column) and its ``adapt_*`` transitions;
:func:`render_retune` the retune transactions (``retune_*`` records),
with the configuration that survived. :func:`render_trails` gives both
sections, headed as the tool heads them, from one run's metric rows and
event records.
"""

from __future__ import annotations

from typing import List

__all__ = ["render_adapt", "render_retune", "render_trails"]


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
    adapt = [e for e in events
             if str(e.get("event", "")).startswith("adapt")]
    retune = [e for e in events
              if str(e.get("event", "")).startswith("retune")]
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

