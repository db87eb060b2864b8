"""The incident flight recorder; counterpart of the JAX package's
``evidence/incident.py``.

A telemetry :class:`~grace_tpu_torch.telemetry.sinks.Sink` that rides a
``MultiSink`` beside the run's JSONL sink. It keeps a bounded ring of the
recent records, and when a trigger fires (a guard trip: ``guard_skip`` /
``guard_fallback_engaged``; an adapt escalation: ``adapt_tighten``; a
drain: ``elastic_drain*``; a consensus escalation; a retune transaction
boundary: ``retune_promote`` / ``retune_demote``) it writes what a
postmortem needs into one file:

* the telemetry ring (the last N records of every kind, verbatim),
* its timeline view (kind counts and events, through
  :func:`grace_tpu_torch.telemetry.timeline.classify`),
* the adapt rung history, the guard, elastic and retune event histories,
* the profiler's stage attribution, when one is attached
  (:meth:`IncidentRecorder.attach_profile`, or
  :meth:`IncidentRecorder.attach_trace` on a capture, through
  :func:`grace_tpu_torch.profiling.analyze_trace`),

as ``<out_dir>/<id>.json`` (default ``grace_tpu_torch/EVIDENCE/
incidents/``), and appends a ``measured`` ledger record for it (tool
``flight_recorder``).

Debounced: triggers less than ``min_gap_steps`` after the last one open
no incident, and a run records at most ``max_incidents``.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
from collections import deque
from typing import Any, Deque, Dict, List, Mapping, Optional, Tuple

from grace_tpu_torch.evidence.ledger import record_artifact, repo_root
from grace_tpu_torch.telemetry.sinks import Sink

__all__ = ["IncidentRecorder", "DEFAULT_TRIGGERS"]

# Event-name prefixes that open an incident.
DEFAULT_TRIGGERS: Tuple[str, ...] = (
    "guard_skip", "guard_fallback_engaged", "adapt_tighten",
    "elastic_drain", "consensus_escalation", "retune_promote",
    "retune_demote")


def _utc_now() -> str:
    return datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")


def _classify(record: Mapping[str, Any]) -> str:
    try:
        from grace_tpu_torch.telemetry.timeline import classify
        return classify(record)
    except Exception:
        return "other"


class IncidentRecorder(Sink):
    """The flight recorder (``write``/``close``/context manager). Host
    code only; ``write`` never raises: a broken disk must not take down
    the training loop it observes."""

    def __init__(self, out_dir: Optional[str] = None, *,
                 run_tag: str = "run",
                 ring_size: int = 256,
                 min_gap_steps: int = 25,
                 max_incidents: int = 8,
                 triggers: Tuple[str, ...] = DEFAULT_TRIGGERS,
                 ledger_path: Optional[str] = None,
                 provenance: Optional[Mapping[str, Any]] = None):
        self.out_dir = out_dir or os.path.join(
            repo_root(), "grace_tpu_torch", "EVIDENCE", "incidents")
        self.run_tag = run_tag
        self.triggers = tuple(triggers)
        self.min_gap_steps = min_gap_steps
        self.max_incidents = max_incidents
        self.ledger_path = ledger_path
        self.provenance = dict(provenance) if provenance else None
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=ring_size)
        self._adapt: List[Dict[str, Any]] = []
        self._guard: List[Dict[str, Any]] = []
        self._elastic: List[Dict[str, Any]] = []
        self._retune: List[Dict[str, Any]] = []
        self._prof: Optional[Dict[str, Any]] = None
        self._last_trigger_step: Optional[int] = None
        self.incidents: List[str] = []        # written file paths
        self._seq = 0
        self._closed = False

    # -- the sink ----------------------------------------------------------
    def write(self, record: Mapping[str, Any]) -> None:
        try:
            rec = dict(record)
            self._ring.append(rec)
            event = str(rec.get("event", ""))
            for prefix, history in (("adapt", self._adapt),
                                    ("guard", self._guard),
                                    ("elastic", self._elastic),
                                    ("retune", self._retune)):
                if event.startswith(prefix):
                    history.append(rec)
                    break
            if self._should_trigger(rec, event):
                self._snapshot(rec, event)
        except Exception as e:               # noqa: BLE001
            print(f"[evidence] flight recorder write failed: {e}",
                  file=sys.stderr, flush=True)

    def close(self) -> None:
        self._closed = True

    # -- postmortem attachments --------------------------------------------
    def attach_profile(self, stage_attribution: Mapping[str, Any]) -> None:
        """Attach a stage-attribution dict (``stages_ms`` and the overlap
        figures); it rides every later incident."""
        self._prof = dict(stage_attribution)

    def attach_trace(self, path: str) -> None:
        """Attach the stage attribution of a profiler capture (a trace file
        or the directory holding it)."""
        from grace_tpu_torch.profiling import analyze_trace
        self.attach_profile(analyze_trace(path).as_dict())

    # -- internals ---------------------------------------------------------
    def _should_trigger(self, rec: Mapping[str, Any], event: str) -> bool:
        if self._closed or len(self.incidents) >= self.max_incidents:
            return False
        if not any(event.startswith(t) for t in self.triggers):
            return False
        step = rec.get("step")
        if (isinstance(step, (int, float)) and
                self._last_trigger_step is not None and
                step - self._last_trigger_step < self.min_gap_steps):
            return False
        if isinstance(step, (int, float)):
            self._last_trigger_step = int(step)
        return True

    def _timeline_view(self) -> Dict[str, Any]:
        kinds: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        for rec in self._ring:
            kind = _classify(rec)
            kinds[kind] = kinds.get(kind, 0) + 1
            if kind not in ("telemetry", "other"):
                events.append({"step": rec.get("step"),
                               "kind": kind,
                               "event": rec.get("event")})
        return {"kind_counts": kinds, "events": events}

    def _snapshot(self, trigger: Dict[str, Any], event: str) -> None:
        self._seq += 1
        step = trigger.get("step")
        inc_id = (f"incident-{self.run_tag}-{self._seq:03d}-"
                  f"{event or 'event'}")
        doc = {
            "id": inc_id,
            "tool": "flight_recorder",
            "trigger": trigger,
            "step": step,
            "telemetry_ring": list(self._ring),
            "watch_timeline": self._timeline_view(),
            "adapt_rungs": list(self._adapt),
            "guard_events": list(self._guard),
            "elastic_events": list(self._elastic),
            "retune_events": list(self._retune),
            "prof": self._prof,
            "provenance": self.provenance,
            "captured_at": _utc_now(),
        }
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, inc_id + ".json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, default=str)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self.incidents.append(path)
        print(f"[evidence] incident recorded: {path}", file=sys.stderr,
              flush=True)
        prov = self.provenance or {}
        kwargs = dict(
            id=inc_id, metric="incident_trigger_step",
            value=step, claim_class="measured", tool="flight_recorder",
            platform=prov.get("platform"), chip=prov.get("device"),
            n_devices=prov.get("n_devices"),
            topology=({"world": prov.get("n_devices"), "tiers": None,
                       "slice": None, "region": None}
                      if prov.get("n_devices") else None),
            config=event, lint_clean=None)
        if self.ledger_path:
            record_artifact(path, ledger_path=self.ledger_path, **kwargs)
        else:
            # Into the port's ledger only for incident files inside the
            # repository: a run pointed at a temporary directory must not
            # leave records of files that live outside it.
            out_abs = os.path.abspath(self.out_dir)
            root = repo_root()
            if out_abs == root or out_abs.startswith(root + os.sep):
                record_artifact(path, **kwargs)
