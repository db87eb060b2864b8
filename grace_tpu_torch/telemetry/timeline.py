"""The run timeline: every sink record kind in one step-keyed sequence;
counterpart of the JAX package's ``telemetry/timeline.py``, line for line
(pure Python, no torch needed).

Telemetry rows (``TelemetryReader``), watch summaries and anomalies, guard
transitions (``GuardMonitor``), consensus repairs (``ConsensusMonitor``)
and the other record families all reach the same JSONL sinks.
:class:`Timeline` joins them: it classifies each record into a **kind**
(:data:`KINDS`), orders the run by ``(step, file position)`` (the file
position keeps the order the run emitted within a step), and offers
queries (:meth:`Timeline.between`, :meth:`Timeline.kinds`,
:meth:`Timeline.at_step`, :meth:`Timeline.anomalies`) and a
:meth:`Timeline.summary` a regression gate can compare.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Mapping, Optional

__all__ = ["KINDS", "classify", "TimelineEvent", "Timeline"]

KINDS = ("telemetry", "watch", "anomaly", "guard", "consensus", "perf",
         "lint", "elastic", "adapt", "retune", "other")


def classify(record: Mapping[str, Any]) -> str:
    """The timeline kind of one flat sink record.

    Records without an ``event`` field are per-step telemetry metric rows
    (the convention of
    :class:`~grace_tpu_torch.telemetry.reader.TelemetryReader`);
    event names map by family prefix. Unknown events are ``other`` — kept,
    never dropped, so a new record kind degrades to visible-but-unsorted
    instead of silently missing from the story.
    """
    event = record.get("event")
    if event is None:
        return "telemetry"
    event = str(event)
    if event == "watch_anomaly":
        return "anomaly"
    if event == "watch":
        return "watch"
    if event.startswith("guard"):
        return "guard"
    if event.startswith("consensus"):
        return "consensus"
    if event.startswith("perf_"):
        return "perf"
    if event == "lint_finding":
        return "lint"
    if event.startswith("elastic"):
        return "elastic"
    if event.startswith("adapt"):
        return "adapt"
    if event.startswith("retune"):
        return "retune"
    return "other"


@dataclasses.dataclass(frozen=True)
class TimelineEvent:
    """One record in run order. ``step`` is None for step-less records
    (provenance-adjacent events, ``guard_only`` flushes); they sort by
    file position among their neighbors."""

    step: Optional[int]
    kind: str
    seq: int                 # original emission order (file position)
    record: Dict[str, Any]

    def brief(self) -> str:
        rec = self.record
        if self.kind == "telemetry":
            bits = [f"{k}={rec[k]:.4g}" for k in
                    ("grad_norm", "compression_error", "wire_bytes")
                    if isinstance(rec.get(k), (int, float))]
            return "metrics " + " ".join(bits)
        if self.kind == "watch":
            return (f"watch summary err_mean="
                    f"{rec.get('compression_error_mean', 0):.4g} "
                    f"skew_max={rec.get('skew_max', 0):.3g} "
                    f"skew_rank={rec.get('skew_rank', -1)}")
        if self.kind == "anomaly":
            return (f"ANOMALY {rec.get('kind', '?')}/"
                    f"{rec.get('metric', '?')} rank={rec.get('rank', -1)} "
                    f"score={rec.get('score', 0):.3g}")
        name = str(rec.get("event", "?"))
        extras = ", ".join(
            f"{k}={v}" for k, v in sorted(rec.items())
            if k not in ("event", "step")
            and isinstance(v, (int, float, bool)))
        return name + (f" ({extras})" if extras else "")


class Timeline:
    """Time-ordered, step-keyed view over one run's sink records."""

    def __init__(self, events: List[TimelineEvent],
                 provenance: Optional[Mapping[str, Any]] = None):
        self.events = events
        self.provenance = dict(provenance) if provenance else None

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_records(cls, records: Iterable[Mapping[str, Any]],
                     provenance: Optional[Mapping[str, Any]] = None
                     ) -> "Timeline":
        events: List[TimelineEvent] = []
        prov = dict(provenance) if provenance else None
        for seq, rec in enumerate(records):
            if not isinstance(rec, Mapping):
                continue
            if "provenance" in rec and prov is None:
                prov = dict(rec["provenance"])
                continue
            step = rec.get("step")
            step = int(step) if isinstance(step, (int, float)) else None
            events.append(TimelineEvent(step=step, kind=classify(rec),
                                        seq=seq, record=dict(rec)))
        # Stable key: records without a step inherit the last seen step so
        # they stay with their neighborhood; file position breaks ties —
        # within one step the run's own emission order IS the causal order
        # (metric row -> watch summary -> anomaly -> guard event).
        keyed, last = [], -1
        for ev in events:
            if ev.step is not None:
                last = ev.step
            keyed.append((last if ev.step is None else ev.step, ev.seq, ev))
        keyed.sort(key=lambda t: (t[0], t[1]))
        return cls([ev for _, _, ev in keyed], provenance=prov)

    @classmethod
    def from_jsonl(cls, path: str) -> "Timeline":
        records = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    continue            # torn tail line of a killed run
        return cls.from_records(records)

    # -- queries ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def kinds(self, *names: str) -> List[TimelineEvent]:
        unknown = set(names) - set(KINDS)
        if unknown:
            raise ValueError(f"unknown timeline kind(s) {sorted(unknown)}; "
                             f"known: {KINDS}")
        return [e for e in self.events if e.kind in names]

    def between(self, start: int, end: int) -> List[TimelineEvent]:
        """Events with ``start <= step <= end`` (step-less events excluded
        — they have no well-defined position in a step range)."""
        return [e for e in self.events
                if e.step is not None and start <= e.step <= end]

    def at_step(self, step: int) -> List[TimelineEvent]:
        return [e for e in self.events if e.step == step]

    def anomalies(self) -> List[TimelineEvent]:
        return self.kinds("anomaly")

    def first(self, kind: str) -> Optional[TimelineEvent]:
        for e in self.events:
            if e.kind == kind:
                return e
        return None

    def steps(self) -> List[int]:
        return sorted({e.step for e in self.events if e.step is not None})

    # -- summary / rendering ------------------------------------------------
    def summary(self) -> dict:
        """The comparable facts of a run — the document
        ``tools/graft_watch.py`` gates against a baseline. Anomaly counts
        are broken down by detector kind, and each family's first
        occurrence step is recorded so a gate can assert not just "no new
        anomalies" but "nothing fired earlier than it used to"."""
        counts = {k: 0 for k in KINDS}
        for e in self.events:
            counts[e.kind] += 1
        anomalies = [e.record for e in self.anomalies()]
        by_kind: Dict[str, int] = {}
        max_score: Dict[str, float] = {}
        for a in anomalies:
            k = str(a.get("kind", "?"))
            by_kind[k] = by_kind.get(k, 0) + 1
            score = a.get("score")
            if isinstance(score, (int, float)):
                max_score[k] = max(max_score.get(k, 0.0), float(score))
        firsts = {}
        for kind in ("anomaly", "guard", "consensus", "lint", "adapt",
                     "retune"):
            ev = self.first(kind)
            if ev is not None:
                firsts[f"first_{kind}_step"] = ev.step
        steps = self.steps()
        return {
            "events": len(self.events),
            "kind_counts": {k: v for k, v in counts.items() if v},
            "step_span": [steps[0], steps[-1]] if steps else None,
            "anomalies": len(anomalies),
            "anomalies_by_kind": by_kind,
            "anomaly_max_score": max_score,
            "anomalous_ranks": sorted({int(a["rank"]) for a in anomalies
                                       if isinstance(a.get("rank"), int)
                                       and a["rank"] >= 0}),
            **firsts,
        }

    def render(self, kinds: Optional[Iterable[str]] = None,
               limit: Optional[int] = None) -> str:
        """Human-readable timeline, one line per event."""
        events = (self.events if kinds is None
                  else self.kinds(*tuple(kinds)))
        if limit is not None and len(events) > limit:
            head = events[:limit]
            trailer = [f"  ... {len(events) - limit} more events "
                       f"(use --limit 0 for all)"]
        else:
            head, trailer = events, []
        out = []
        if self.provenance:
            out.append("== provenance ==")
            for k, v in self.provenance.items():
                out.append(f"  {k}: {v}")
            out.append("")
        out.append(f"== timeline ({len(events)} events) ==")
        for e in head:
            step = "     ?" if e.step is None else f"{e.step:>6d}"
            out.append(f"  step {step}  [{e.kind:<9s}] {e.brief()}")
        out.extend(trailer)
        return "\n".join(out)
