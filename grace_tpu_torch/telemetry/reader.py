"""Host-side telemetry drain: one device-to-host transfer a flush window;
counterpart of the JAX package's ``telemetry/reader.py``.

The training loop calls :meth:`TelemetryReader.update` every step; only
every ``every``-th call flushes, and a flush moves the rings (the
telemetry ring and, when armed, the cross-rank watch ring), their step ids
and the guard's counters to the host as one byte buffer in one transfer.
Between flushes the loop never waits on telemetry.

* Rows are keyed by the GRACE step counter, which advances only on steps
  the guard accepted: a skipped step leaves no row. The guard's counters
  ride in the same transfer and are stamped on the last record of the
  flush as ``guard_*`` fields, so skips stay visible.
* More than ``capacity`` accepted steps between flushes overwrite the
  oldest rows on the device; the reader counts the gap in
  :attr:`dropped` and stamps ``dropped_steps`` on the flush.
* Across ranks the ring is per rank. A flush all-gathers every rank's
  buffer (one collective, which every rank of ``group`` must join), then
  aggregates each field over the ranks by its ``agg`` in
  :data:`~grace_tpu_torch.telemetry.state.FIELDS`. Watch rows
  (``{"event": "watch", ...}``) follow the metric rows: their replicated
  columns read once, their per-rank ``gather`` columns assembled into
  W-vectors (:data:`~grace_tpu_torch.telemetry.aggregate.WATCH_FIELDS`).
* ``anomaly=...`` arms the streaming detectors
  (:class:`~grace_tpu_torch.telemetry.anomaly.WatchMonitor`): each
  flush's records run through them, and their ``watch_anomaly`` records
  land in the same sink.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from grace_tpu_torch.telemetry.aggregate import WATCH_FIELDS, WatchState
from grace_tpu_torch.telemetry.anomaly import AnomalyConfig, WatchMonitor
from grace_tpu_torch.telemetry.state import FIELDS, TelemetryState

__all__ = ["TelemetryReader"]

_GUARD_FIELDS = ("notfinite_count", "last_bad_step", "consecutive",
                 "fallback_remaining", "step")


def _children(node) -> list:
    from grace_tpu_torch.resilience.guard import GuardState
    if isinstance(node, GuardState):
        return [node.inner]             # settles a pending step
    if isinstance(node, (list, tuple)):
        return list(node)
    if isinstance(node, dict):
        return list(node.values())
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [getattr(node, f.name) for f in dataclasses.fields(node)]
    return []


def collect(tree, cls) -> list:
    """Every node of type ``cls`` in a state tree (a ``TrainState``, a
    ``GuardState``, a ``GraceState``, or lists, tuples and dicts of
    them), in walk order. Tensors, modules and optimizers are leaves."""
    found: list = []
    stack = [tree]
    while stack:
        node = stack.pop(0)
        if isinstance(node, cls):
            found.append(node)
        if not isinstance(node, (torch.Tensor, torch.nn.Module,
                                 torch.optim.Optimizer)):
            stack[:0] = _children(node)
    return found


def _aggregate(values: np.ndarray, agg: str) -> float:
    if agg == "max":
        return float(values.max())
    if agg == "first":
        return float(values[0])
    return float(values.mean())


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _normalize_anomaly(anomaly, sink) -> Optional[WatchMonitor]:
    """None/False (off), True (defaults), an AnomalyConfig, a dict of its
    kwargs, or a ready WatchMonitor (its own sink wins if it has one)."""
    if anomaly is None or anomaly is False:
        return None
    if isinstance(anomaly, WatchMonitor):
        if anomaly.sink is None:
            anomaly.sink = sink
        return anomaly
    if anomaly is True:
        return WatchMonitor(sink=sink)
    if isinstance(anomaly, AnomalyConfig):
        return WatchMonitor(sink=sink, config=anomaly)
    if isinstance(anomaly, dict):
        return WatchMonitor(sink=sink, config=AnomalyConfig(**anomaly))
    raise TypeError(f"anomaly must be None/bool/dict/AnomalyConfig/"
                    f"WatchMonitor; got {type(anomaly).__name__}")


class TelemetryReader:
    """Flush the telemetry ring through a sink every ``every`` steps::

        reader = TelemetryReader(JSONLSink("run.jsonl",
                                           provenance=run_provenance("synthetic")),
                                 every=20, anomaly=True)
        for i, batch in enumerate(batches):
            state, loss = step(state, batch)
            reader.update(i, state)
        reader.flush(state)      # drain the tail
        reader.close()

    ``group`` is the process group whose rings a flush aggregates (None:
    the default group, when one is initialised); every rank of it calls
    :meth:`flush` at the same steps.
    """

    def __init__(self, sink: Optional[Any] = None, every: int = 10,
                 anomaly=None, group: Optional[Any] = None):
        if every < 1:
            raise ValueError(f"flush interval must be >= 1; got {every}")
        self.sink = sink
        self.every = every
        self.group = group
        self.dropped = 0         # steps lost to ring wraparound
        self.flushes = 0         # device-to-host transfers made
        self.monitor = _normalize_anomaly(anomaly, sink)
        self._last_step = -1     # newest step already emitted
        self._last_watch_step = -1

    def update(self, step: int, state) -> List[dict]:
        """Per-iteration hook: flushes on every ``every``-th call."""
        if (step + 1) % self.every == 0:
            return self.flush(state)
        return []

    def _world(self) -> int:
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size(self.group)
        return 1

    def flush(self, state) -> List[dict]:
        """Drain every unseen ring row in ONE device-to-host transfer and
        write the records to the sink: the metric rows (step-ordered), then
        the watch rows, then any ``watch_anomaly`` records the armed
        detectors found in them."""
        from grace_tpu_torch.resilience.guard import GuardState

        telems = collect(state, TelemetryState)
        watches = collect(state, WatchState)
        if not telems and not watches:
            return []
        guards = collect(state, GuardState)
        parts = []
        for t in telems + watches:
            parts += [t.rings, t.steps]
        if guards:
            parts.append(guards[0].counters())
        sizes = [p.numel() * p.element_size() for p in parts]
        buf = torch.cat([_as_bytes(p) for p in parts])
        world = self._world()
        if world > 1:
            every_rank = torch.empty(world * buf.numel(), dtype=torch.uint8,
                                     device=buf.device)
            dist.all_gather_into_tensor(every_rank, buf, group=self.group)
            buf = every_rank
        host = buf.cpu().numpy().reshape(world, -1)   # the one transfer
        self.flushes += 1
        offsets = np.cumsum([0] + sizes)
        chunks = [host[:, offsets[i]:offsets[i + 1]]
                  for i in range(len(parts))]
        guard_vals = None
        if guards:
            vals = chunks.pop()[0].view(np.int32)
            guard_vals = {f"guard_{name}": int(v)
                          for name, v in zip(_GUARD_FIELDS, vals)}

        watch_records = self._watch_records(watches,
                                            chunks[2 * len(telems):], world)
        records: List[dict] = []
        newest = self._last_step
        n_fields = len(FIELDS)
        for ti, t in enumerate(telems):
            cap = t.steps.shape[0]
            rings = np.ascontiguousarray(chunks[2 * ti]).view(
                np.float32).reshape(world, cap, n_fields)
            steps = np.ascontiguousarray(chunks[2 * ti + 1][0]).view(
                np.int32)
            fresh = np.flatnonzero(steps > self._last_step)
            for slot in fresh[np.argsort(steps[fresh])]:
                rec = {"step": int(steps[slot])}
                if len(telems) > 1:
                    rec["telemetry_index"] = ti
                for fi, (name, agg) in enumerate(FIELDS):
                    rec[name] = _aggregate(rings[:, slot, fi], agg)
                records.append(rec)
                newest = max(newest, int(steps[slot]))

        if records:
            expected = newest - self._last_step
            seen = len({r["step"] for r in records})
            gap = max(0, expected - seen)
            if gap:
                self.dropped += gap
                records[-1]["dropped_steps"] = gap
            if guard_vals:
                records[-1].update(guard_vals)
            self._last_step = newest
            if self.sink is not None:
                for rec in records:
                    self.sink.write(rec)
        elif guard_vals and self.sink is not None and not watch_records:
            # No fresh rows (every step of the window skipped, or already
            # flushed): still report the guard, so a bad run is not silent.
            self.sink.write({"event": "guard_only", **guard_vals})
        if self.sink is not None:
            for rec in watch_records:
                self.sink.write(rec)
        out = records + watch_records
        if self.monitor is not None and out:
            # The monitor writes its findings to the sink itself.
            out = out + self.monitor.observe(out)
        return out

    def _watch_records(self, watches, chunks, world: int) -> List[dict]:
        """Watch rows from the flushed bytes: the replicated columns read
        once, the per-rank ``gather`` columns as W-vectors."""
        n_fields = len(WATCH_FIELDS)
        records: List[dict] = []
        newest = self._last_watch_step
        for wi, w in enumerate(watches):
            cap = w.steps.shape[0]
            rings = np.ascontiguousarray(chunks[2 * wi]).view(
                np.float32).reshape(world, cap, n_fields)
            steps = np.ascontiguousarray(chunks[2 * wi + 1][0]).view(
                np.int32)
            fresh = np.flatnonzero(steps > self._last_watch_step)
            for slot in fresh[np.argsort(steps[fresh])]:
                rec: dict = {"event": "watch", "step": int(steps[slot])}
                if len(watches) > 1:
                    rec["watch_index"] = wi
                for fi, (name, agg) in enumerate(WATCH_FIELDS):
                    if agg == "gather":
                        rec[name] = [float(v) for v in rings[:, slot, fi]]
                    else:
                        rec[name] = float(rings[0, slot, fi])
                rec["skew_rank"] = int(rec["skew_rank"])
                records.append(rec)
                newest = max(newest, int(steps[slot]))
        self._last_watch_step = newest
        return records

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()
