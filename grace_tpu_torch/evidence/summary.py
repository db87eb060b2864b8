"""Markdown renderers of the evidence; the port's counterpart of the
repository's ``tools/evidence_summary.py`` for the subsystems the port
has.

* :func:`ledger_view` / :func:`ledger_note` / :func:`generic_section`:
  the ledger's records by capture, the sub-line that ties a section to
  its records, and the table of a capture that no dedicated reader
  renders;
* :func:`incident_rollup`: the flight recorder's one-line roll-up;
* :func:`sec_lint`, :func:`sec_prof`, :func:`sec_elastic`,
  :func:`sec_region`, :func:`sec_adapt`, :func:`sec_retune`,
  :func:`sec_watch`, :func:`sec_tune`: one line each over an evidence
  document in the JAX package's schema, written by the JAX tools or by the
  port's own command lines (``python -m grace_tpu_torch.analysis
  --all-configs``, ``.profiling``, ``.telemetry.watch``, ``.tuning``; the
  retune drill of ``chip_smoke.py``, tool ``chip_smoke``);
* :func:`build`: the whole summary of named documents and a ledger;
* :func:`main`: ``python -m grace_tpu_torch.evidence.summary [--root DIR]
  [--ledger PATH] [--update-readme]``, the summary of the documents under
  ``DIR`` (default: ``grace_tpu_torch/``, where the port's command lines
  write theirs) against the port's ledger, printed or spliced between the
  ``<!-- evidence:begin -->`` / ``<!-- evidence:end -->`` markers of
  ``DIR/README.md`` (``--update-readme`` needs ``--root`` given: the
  repository root's README is the JAX package's).

The CPU sweep's section and the benchmark's (headline, sweep, variants,
BERT, projection, curves) wait for the port's benchmark, their writer.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from grace_tpu_torch.evidence.ledger import (LEDGER_PATH, latest_by_id,
                                             load_ledger, repo_root)

__all__ = ["ledger_view", "ledger_note", "generic_section",
           "incident_rollup", "sec_lint", "sec_prof", "sec_elastic",
           "sec_region", "sec_adapt", "sec_retune", "sec_watch", "sec_tune",
           "SECTIONS", "build", "load_docs", "splice_summary", "main"]

PROG = "python -m grace_tpu_torch.evidence.summary"
BEGIN, END = "<!-- evidence:begin -->", "<!-- evidence:end -->"


def ledger_view(path: str = LEDGER_PATH
                ) -> Tuple[Dict[str, List[dict]], Dict[str, dict]]:
    """``(by_capture_basename, latest_by_id)`` over the ledger at
    ``path``; empty dicts when there is none."""
    try:
        latest = latest_by_id(load_ledger(path))
    except Exception:                                      # noqa: BLE001
        return {}, {}
    by_capture: Dict[str, List[dict]] = {}
    for rec in latest.values():
        base = os.path.basename(str(rec.get("capture") or ""))
        if base:
            by_capture.setdefault(base, []).append(rec)
    for recs in by_capture.values():
        recs.sort(key=lambda r: (r.get("claim_class") or "",
                                 r.get("id") or ""))
    return by_capture, latest


def ledger_note(recs) -> List[str]:
    """The sub-line tying a section to the ledger ids claims cite."""
    if not recs:
        return []
    cite = ", ".join(f"`{r.get('id')}` [{r.get('claim_class', '?')}]"
                     for r in recs)
    return [f"<sub>ledger: {cite}</sub>"]


def _fmt(x, nd=2):
    return "—" if x is None else f"{x:.{nd}f}"


def _tail(name: str, doc: Mapping[str, Any], note: str = "") -> str:
    when = (doc.get("captured_at") or "").split("T")[0]
    return f" (`{name}`{', ' + when if when else ''}){note}."


def _footprint_bits(fp: Mapping[str, Any]) -> str:
    ok = all(bool(v) for v in fp.values())
    return ("re-shard footprint vs flow pass 7 model: "
            + ("matches at " + ", ".join(f"W={k}" for k in sorted(fp))
               if ok else f"MISMATCH {fp}"))


def _floor_bits(floor: Mapping[str, Any]) -> str:
    met = "met" if floor.get("met") else "MISSED"
    return (f"convergence floor {met} "
            f"(final loss {_fmt(floor.get('final_loss'), 4)} vs "
            f"floor {_fmt(floor.get('floor'), 2)})")


def _variants(n) -> str:
    return "bit-identical" if n == 1 else f"{n} variants"


def sec_lint(doc, name: str = "LINT_LAST.json") -> List[str]:
    """The auditor's full-matrix run: errors and warnings over the configs
    and repo rules, the passes with findings, and the bucketed entries'
    static overlap bounds."""
    if not (isinstance(doc, dict) and "errors" in doc):
        return []
    counts = doc.get("pass_counts") or {}
    per_pass = ""
    if counts:
        dirty = {p: n for p, n in counts.items() if n}
        per_pass = ("; per-pass findings: "
                    + ", ".join(f"{p} {n}" for p, n in sorted(dirty.items()))
                    if dirty else f"; all {len(counts)} passes clean")
    bounds = doc.get("overlap_bounds") or {}
    bound_s = ""
    if bounds:
        bound_s = ("; bucketed overlap bounds: " + ", ".join(
            f"{n} static≤{rep.get('static_overlap_bound')} "
            f"({rep.get('independent_chains')}/"
            f"{rep.get('expected_chains')} chains)"
            for n, rep in sorted(bounds.items())
            if isinstance(rep, dict) and "error" not in rep))
    command = ("python -m grace_tpu_torch.analysis --all-configs"
               if doc.get("tool") == "grace_tpu_torch.analysis"
               else "graft_lint --all-configs")
    return [f"Static analysis: `{command}` → "
            f"{doc['errors']} error(s) / {doc.get('warnings', 0)} "
            f"warning(s) over {doc.get('configs_audited', '?')} configs + "
            f"{doc.get('rules_checked', '?')} repo rules"
            f"{per_pass}{bound_s}" + _tail(name, doc)]


def sec_prof(doc, name: str = "PROF_LAST.json") -> List[str]:
    """A trace's attribution: the device total and top stage, the overlap
    fraction and its sandwich, the step p50, the baseline regressions."""
    if not (isinstance(doc, dict) and doc.get("stages_ms")):
        return []
    top = max(doc["stages_ms"].items(), key=lambda kv: kv[1])
    ov = doc.get("overlap_fraction")
    steps = doc.get("step_times") or {}
    bits = [f"total device time {_fmt(doc.get('total_device_ms'), 3)} "
            f"ms, top stage {top[0]} ({_fmt(top[1], 3)} ms)"]
    if ov is not None:
        bits.append(f"overlap fraction {100.0 * ov:.1f}%")
    sand = doc.get("overlap_sandwich")
    if isinstance(sand, dict):
        verdict = "VIOLATED" if sand.get("violations") else "holds"
        bits.append(
            f"measured≤static sandwich vs {sand.get('config')} "
            f"(bound {sand.get('static_overlap_bound')}): {verdict}")
    if steps.get("p50_ms") is not None:
        bits.append(f"step p50 {_fmt(steps['p50_ms'], 3)} ms")
    regr = doc.get("regressions")
    if regr is not None:
        bits.append(f"{len(regr)} baseline regression(s)")
    note = f" — {doc['note']}" if doc.get("note") else ""
    command = ("python -m grace_tpu_torch.profiling"
               if doc.get("tool") == "grace_tpu_torch.profiling"
               else "perf_report")
    return [f"Performance attribution: `{command} --trace "
            f"{doc.get('trace', '?')}` → " + ", ".join(bits)
            + _tail(name, doc, note)]


def sec_elastic(doc, name: str = "ELASTIC_LAST.json") -> List[str]:
    """The elastic drill: the world cycle, the resizes, the rejoin
    barrier, the convergence floor and the footprint checks."""
    if not (isinstance(doc, dict) and doc.get("tool") == "chaos_smoke"):
        return []
    cycle = " → ".join(str(w) for w in (doc.get("world_cycle") or []))
    resizes = doc.get("resize_events") or []
    rejoin = doc.get("rejoin") or {}
    floor = doc.get("floor") or {}
    fp = doc.get("footprint") or {}
    bits = [f"world cycle {cycle}" if cycle else "no resize recorded",
            f"{len(resizes)} resize event(s)"]
    if rejoin:
        bits.append(
            f"rejoin barrier: {rejoin.get('barrier_repairs', '?')} "
            f"repair(s) for {rejoin.get('rejoins', '?')} rejoin(s), "
            f"replicas {_variants(rejoin.get('replica_variants'))} "
            f"(fingerprint {rejoin.get('fingerprint_bytes', '?')} B)")
    if floor:
        bits.append(_floor_bits(floor))
    if fp:
        bits.append(_footprint_bits(fp))
    return ["Elastic training (graft-elastic): `chaos_smoke --elastic` → "
            + ", ".join(bits) + _tail(name, doc)]


def sec_region(doc, name: str = "REGION_LAST.json") -> List[str]:
    """The cross-region drill: the world cycle and layout, the drain's
    scope, the region rejoin barrier, the floor, the footprint checks and
    the guard through the drift."""
    if not (isinstance(doc, dict) and doc.get("tool") == "chaos_smoke"):
        return []
    cycle = " → ".join(str(w) for w in (doc.get("world_cycle") or []))
    drain = doc.get("drain") or {}
    rejoin = doc.get("rejoin") or {}
    floor = doc.get("floor") or {}
    fp = doc.get("footprint") or {}
    layout = (f"{doc.get('regions', '?')} regions × "
              f"region {doc.get('region_size', '?')} / "
              f"slice {doc.get('slice_size', '?')}")
    bits = [f"world cycle {cycle} ({layout})"]
    if drain:
        scoped = ("region-wide" if drain.get("region_wide")
                  else f"PARTIAL scope {drain.get('scope')}")
        bits.append(
            f"{drain.get('transitions', '?')} drain transition(s) for "
            f"drift on ranks {doc.get('drift_ranks')} — {scoped}, "
            f"{drain.get('drain_timeouts', 0)} watchdog timeout(s)")
    if rejoin:
        bits.append(
            f"region rejoin barrier: {rejoin.get('barrier_repairs', '?')}"
            f" repair(s) for {rejoin.get('rejoins', '?')} region "
            f"rejoin(s) ({rejoin.get('rejoined_ranks', '?')} ranks), "
            f"replicas {_variants(rejoin.get('replica_variants'))}")
    if floor:
        bits.append(_floor_bits(floor))
    if fp:
        bits.append(_footprint_bits(fp))
    if doc.get("guard_silent") is not None:
        bits.append("guard " + ("silent through the drift phase"
                                if doc.get("guard_silent") else "TRIPPED"))
    return ["Cross-region elasticity (graft-region): `chaos_smoke "
            "--region` → " + ", ".join(bits) + _tail(name, doc)]


def sec_adapt(doc, name: str = "ADAPT_LAST.json") -> List[str]:
    """The adapt drill: the ladder, tightens and loosens, and whether the
    controller acted before the guard."""
    if not (isinstance(doc, dict) and doc.get("tool") == "chaos_smoke"):
        return []
    ti = doc.get("tighten") or {}
    lo = doc.get("loosen") or {}
    within = "within one window" if ti.get("within_one_window") \
        else "LATE (outside one window)"
    order = ("adapt_tighten precedes the first guard event"
             if doc.get("ordering_ok")
             else "ORDERING VIOLATED (guard fired first)")
    bits = [
        f"{len(doc.get('ladder') or [])}-rung ladder, window "
        f"{doc.get('window', '?')} steps",
        f"drift → {ti.get('count', '?')} tighten(s), first at step "
        f"{ti.get('first_step', '?')} ({within})",
        f"quiet → {lo.get('count', '?')} loosen(s)",
        f"NaN → {doc.get('guard_skips', '?')} guard skip(s), "
        f"{doc.get('escalations', '?')} escalate-and-hold(s)",
        order,
    ]
    return ["Adaptive compression (graft-adapt): `chaos_smoke --adapt` → "
            + ", ".join(bits) + _tail(name, doc)]


# The retune drill's writers: the JAX package's chaos drill and the port's
# card drill (chip_smoke.py phase [35]).
_RETUNE_COMMANDS = {"chaos_smoke": "chaos_smoke --retune",
                    "chip_smoke": "chip_smoke.py [35]"}


def sec_retune(doc, name: str = "RETUNE_LAST.json") -> List[str]:
    """The retune drill: drift verdict, the funnel's winner, the two-phase
    promotion with its migration counts, the sabotaged promotion's
    demotion, and the event order."""
    if not (isinstance(doc, dict)
            and doc.get("tool") in _RETUNE_COMMANDS):
        return []
    drift = doc.get("drift") or {}
    fwd = doc.get("forward_promotion") or {}
    sab = doc.get("sabotage") or {}
    funnel = doc.get("funnel") or {}
    mig = fwd.get("migration") or {}
    mem = mig.get("mem") or {}
    comp = mig.get("comp") or {}
    bits = [
        f"{doc.get('incumbent', '?')} → {doc.get('candidate', '?')} "
        f"over window {doc.get('window', '?')} steps",
        f"drift verdict at step {drift.get('verdict_step', '?')} "
        f"(onset {drift.get('from_step', '?')})",
    ]
    if funnel:
        bits.append(f"re-tune funnel winner `{funnel.get('winner', '?')}` "
                    f"({len(funnel.get('measured') or [])} measured, "
                    f"{len(funnel.get('skipped') or [])} skipped)")
    if fwd:
        bits.append(
            f"two-phase promotion at step {fwd.get('step', '?')} "
            f"(state migration carried {mem.get('carried', 0)}+"
            f"{comp.get('carried', 0)} / overlap "
            f"{mem.get('overlap', 0)}+{comp.get('overlap', 0)} / "
            f"fresh {mem.get('fresh', 0)}+{comp.get('fresh', 0)}, "
            f"replicas {_variants(fwd.get('replica_variants'))})")
    if sab:
        within = ("inside probation" if sab.get("within_probation")
                  else "OUTSIDE probation")
        bit = ("bit-exact" if sab.get("bit_exact")
               else "NOT bit-exact" if sab.get("restored")
               else "NOT restored")
        bits.append(
            f"sabotaged promote → `{sab.get('trigger', '?')}` at step "
            f"{sab.get('trigger_step', '?')} ({within}), demotion to "
            f"last-known-good {bit}")
    bits.append("drift→prepare→promote→clear ordering holds"
                if doc.get("ordering_ok") else "ORDERING VIOLATED")
    return ["Online re-tuning (graft-retune): "
            f"`{_RETUNE_COMMANDS[doc['tool']]}` → " + ", ".join(bits)
            + _tail(name, doc)]


# The watch document's writers: the JAX package's tool and the port's.
_WATCH_COMMANDS = {"graft_watch": "graft_watch",
                   "grace_tpu_torch.telemetry.watch":
                       "python -m grace_tpu_torch.telemetry.watch"}


def sec_watch(doc, name: str = "WATCH_LAST.json") -> List[str]:
    """The watch drill: event counts, anomalies and flagged ranks."""
    if not (isinstance(doc, dict) and doc.get("tool") in _WATCH_COMMANDS):
        return []
    counts = doc.get("kind_counts") or {}
    bits = [f"{doc.get('events', '?')} events "
            f"({', '.join(f'{k} {v}' for k, v in sorted(counts.items()))})",
            f"{doc.get('anomalies', 0)} anomaly record(s)"]
    ranks = doc.get("anomalous_ranks")
    if ranks:
        bits.append(f"anomalous rank(s) {ranks} first flagged at step "
                    f"{doc.get('first_anomaly_step')}")
    regr = doc.get("regressions")
    if regr is not None:
        bits.append(f"{len(regr)} baseline regression(s)")
    note = (" — seeded single-rank drift scenario, not a healthy run"
            if ranks else "")
    return [f"Run health (graft-watch): `{_WATCH_COMMANDS[doc['tool']]} "
            f"{doc.get('artifact', '?')}` → " + ", ".join(bits)
            + _tail(name, doc, note)]


# The tuner's writers: the JAX package's and the port's.
_TUNE_TOOLS = ("graft_tune", "grace_tpu_torch.tuning")


def sec_tune(doc, name: str = "TUNE_LAST.json") -> List[str]:
    """The tuner: each topology's funnel counts and top static pick, the
    measured winner with its overlap sandwich."""
    if not (isinstance(doc, dict) and doc.get("tool") in _TUNE_TOOLS):
        return []
    bits = []
    for label, st in sorted((doc.get("static") or {}).items()):
        c = st.get("counts") or {}
        top = (st.get("ranking") or [{}])[0].get("candidate", "?")
        bits.append(
            f"{label}: {c.get('enumerated', '?')} enumerated → "
            f"{c.get('capability_rejected', 0)} capability / "
            f"{c.get('numeric_rejected', 0)} numeric / "
            f"{c.get('degradation_rejected', 0)} degradation rejected "
            f"→ {c.get('shortlisted', 0)} shortlisted, "
            f"top static pick `{top}`")
    w = doc.get("winner")
    if w:
        s = w.get("overlap_sandwich") or {}
        m = w.get("measured") or {}
        verdict = "holds" if s.get("holds") else "VIOLATED"
        bits.append(
            f"winner `{w.get('candidate')}` at {doc.get('target')} "
            f"(measured step {m.get('measured_step_ms', '?')} ms, "
            f"×{m.get('measured_speedup_vs_dense', '?')} vs dense "
            f"same-session; measured≤static overlap sandwich "
            f"{s.get('measured_overlap')}≤"
            f"{s.get('static_overlap_bound')}: {verdict}) — load with "
            f"`grace_from_params({os.path.splitext(name)[0]}.winner."
            f"grace_params)`")
    elif doc.get("static_only"):
        bits.append("static-only survey (no measured winner stamped)")
    platform = (doc.get("provenance") or {}).get("platform")
    note = (" — CPU-mesh pipeline evidence, not a chip capture"
            if platform and platform not in ("tpu", "gpu") else "")
    return [f"Autotuning (graft-tune): `{doc['tool']}` → " + "; ".join(bits)
            + _tail(name, doc, note)]


def generic_section(base: str, recs) -> List[str]:
    """A capture in the ledger that no reader here renders: its ids,
    metric, class and provenance from its records."""
    out = [f"**`{base}`** (from the evidence ledger — no dedicated "
           "reader)", "",
           "| ledger id | metric | value | class | platform | devices |"
           " captured |", "|---|---|---|---|---|---|---|"]
    for r in recs:
        when = (r.get("timestamp") or "").split("T")[0]
        out.append(
            f"| `{r.get('id')}` | {r.get('metric', '?')} | "
            f"{r.get('value')} | {r.get('claim_class', '?')} | "
            f"{r.get('platform') or '—'} | {r.get('n_devices') or '—'} | "
            f"{when or '—'} |")
    return out


def incident_rollup(latest: Mapping[str, Mapping],
                    incident_dir: Optional[str] = None,
                    root: Optional[str] = None) -> List[str]:
    """The flight recorder's roll-up: its ledger records and the incident
    files under ``incident_dir`` (default: the port's)."""
    root = root or repo_root()
    incident_dir = incident_dir or os.path.join(
        root, "grace_tpu_torch", "EVIDENCE", "incidents")
    incs = [r for r in latest.values()
            if r.get("tool") == "flight_recorder"]
    files = glob.glob(os.path.join(incident_dir, "*.json"))
    if not incs and not files:
        return []
    label = os.path.relpath(incident_dir, root)
    if label.startswith(".."):
        label = incident_dir
    return [f"Flight recorder: {len(files)} incident record(s) under "
            f"`{label}/` ({len(incs)} ledger-attached) — each "
            "snapshots the telemetry ring, watch timeline, adapt rung "
            "history and profiler attribution at its trigger step."]


# Base name → reader, in render order.
SECTIONS: Tuple[Tuple[str, Callable[..., List[str]]], ...] = (
    ("LINT_LAST.json", sec_lint),
    ("PROF_LAST.json", sec_prof),
    ("ELASTIC_LAST.json", sec_elastic),
    ("REGION_LAST.json", sec_region),
    ("ADAPT_LAST.json", sec_adapt),
    ("RETUNE_LAST.json", sec_retune),
    ("WATCH_LAST.json", sec_watch),
    ("TUNE_LAST.json", sec_tune),
)


def build(docs: Mapping[str, Any], ledger_path: str = LEDGER_PATH,
          incident_dir: Optional[str] = None,
          root: Optional[str] = None) -> str:
    """The summary of ``docs`` (base name → loaded document; a name of
    :data:`SECTIONS` picks its reader) against the ledger: each section
    with its ledger note, then a generic table per ledger capture no
    section read, then the incident roll-up."""
    by_capture, latest = ledger_view(ledger_path)
    parts: List[str] = []
    covered = set()
    for base, render in SECTIONS:
        covered.add(base)
        lines = render(docs.get(base), base)
        if not lines:
            continue
        parts += lines
        parts += ledger_note(by_capture.get(base) or [])
        parts.append("")
    extras = sorted(base for base, recs in by_capture.items()
                    if base not in covered
                    and not all(r.get("tool") == "flight_recorder"
                                for r in recs))
    for base in extras:
        parts += generic_section(base, by_capture[base])
        parts.append("")
    parts += incident_rollup(latest, incident_dir, root)
    return "\n".join(parts).rstrip() + "\n"


def load_docs(root: str) -> Dict[str, Any]:
    """Every :data:`SECTIONS` document found under ``root``, by base name
    (a JSON document, or the rows of a JSON-lines file)."""
    from grace_tpu_torch.evidence.backfill import load_doc

    docs = {}
    for base, _ in SECTIONS:
        doc = load_doc(os.path.join(root, base))
        if doc is not None:
            docs[base] = doc
    return docs


def splice_summary(readme_path: str, md: str) -> None:
    """Replace the text between the evidence markers of ``readme_path``
    with ``md``; SystemExit when the file lacks the markers."""
    with open(readme_path) as f:
        text = f.read()
    if BEGIN not in text or END not in text:
        raise SystemExit(f"{readme_path} lacks {BEGIN} / {END} markers")
    pre = text.split(BEGIN)[0]
    post = text.split(END)[1]
    with open(readme_path, "w") as f:
        f.write(pre + BEGIN + "\n" + md + END + post)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="directory of the evidence documents (default: "
                         "grace_tpu_torch/)")
    ap.add_argument("--ledger", default=LEDGER_PATH,
                    help="ledger path (default: the port's)")
    ap.add_argument("--update-readme", action="store_true",
                    help="splice the summary into <root>/README.md "
                         "(needs --root)")
    args = ap.parse_args(argv)
    if args.update_readme and args.root is None:
        print(f"[{PROG}] --update-readme needs --root: the repository "
              "root's README.md is the JAX package's", file=sys.stderr)
        return 2
    root = args.root or os.path.join(repo_root(), "grace_tpu_torch")
    md = build(load_docs(root), args.ledger)
    if not args.update_readme:
        print(md, end="")
        return 0
    path = os.path.join(root, "README.md")
    splice_summary(path, md)
    print(f"{path} updated")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
