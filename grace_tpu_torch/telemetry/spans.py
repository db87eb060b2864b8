"""The span log: every :func:`~grace_tpu_torch.telemetry.scopes.trace_stage`
span of a few steps, timed on the host and on the card without the
profiler, on one clock.

Arm it, run the steps, collect::

    from grace_tpu_torch.telemetry import counters, spans
    spans.arm(max_steps=20, device=device)
    for _ in range(20):
        state, loss = step(state, batch)
    log = spans.collect()          # the one call that synchronises
    spans.disarm()
    spans.host_lead_ms(log), spans.per_step_ms(log, "grace/buffer_mean")
    counters.collective_counts()   # the same steps' collectives

While it is armed, every span's enter and exit stamps
``time.perf_counter_ns()`` and records a pooled timing ``torch.cuda.Event``
on the stream current at :func:`arm` (the one the step runs on; looking
the current stream up again at every record would double the cost).
:func:`collect` turns each record into a :class:`Span`: its name, its
parent's index in the log (-1 for a root), its step, and its host and
device start and end in nanoseconds. The train step's root span
``grace/step`` is the parent of every span of its step, and every span of
one step carries that step's index (0 for the first step after
:func:`arm`; a span between steps carries the next one's). A span's self
time is its host duration less its children's (:func:`self_ns`).

**One clock.** :func:`arm` synchronises, records an anchor event and
reads ``perf_counter_ns()`` until the event has run: the event's device
time lies between the reading before its record and the first reading
after it completes, so their midpoint is the anchor and half their
distance its error (:attr:`Log.anchor_error_ns`, the tightest of a few
tries). A device time is the anchor plus the anchor event's
``elapsed_time`` to the span's event. Host and device times are then both
on the host's monotonic clock, which every rank's process on a machine
shares, so the ranks' logs line up (:func:`gather`,
:func:`arrival_skew_ms`). Off the card the device fields are None.

**Room.** The log holds ``max_steps`` steps of at most
:data:`SPANS_PER_STEP` spans each on average, allocated at :func:`arm`
(the events too), and never grows: a span beyond that room is counted in
:attr:`Log.dropped` and not stored.

**Counters.** Arming the log arms the collective counters from zero
(:mod:`grace_tpu_torch.telemetry.counters`), and disarming it disarms
them, so the log's steps and their collectives are read together.

**Cost.** Armed, a span costs two clock readings and two event records:
about 16 µs of host time on an H100's host, most of it the two records;
the counters add about a microsecond a collective. Disarmed, a span costs
one flag check beside the profiler's, and nothing is allocated. Under
``torch.profiler`` the same spans stay ``record_function`` ranges, on the
profiler's own clock.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import List, Optional, Sequence

from grace_tpu_torch.telemetry import counters, scopes

__all__ = ["Span", "Log", "arm", "disarm", "collect", "gather",
           "self_ns", "per_step_ms", "host_lead_ms", "arrival_skew_ms"]

# Spans a step has room for, by default: ResNet-50's grouped Top-K step
# opens about 15, a per-leaf codec path a few a leaf.
SPANS_PER_STEP = 256
_ANCHOR_TRIES = 5


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    parent: int                      # index in the log; -1 for a root
    step: int
    host_start_ns: int
    host_end_ns: int
    device_start_ns: Optional[int]   # None off the card
    device_end_ns: Optional[int]

    @property
    def host_ns(self) -> int:
        return self.host_end_ns - self.host_start_ns


@dataclasses.dataclass
class Log:
    """One rank's collected spans, in the order they opened."""

    spans: List[Span]
    dropped: int
    steps: int                       # grace/step spans closed while armed
    anchor_error_ns: Optional[int]   # None off the card
    rank: int = 0


class _Recorder:
    """The armed log: preallocated columns, one row a span."""

    def __init__(self, max_steps: int, device):
        import torch

        self.max_steps = max_steps
        cap = self.cap = max_steps * SPANS_PER_STEP
        self.names: List[Optional[str]] = [None] * cap
        self.parents = [-1] * cap
        self.step_of = [0] * cap
        self.host = [0] * (2 * cap)
        self.n = self.dropped = self.step = 0
        self.current = -1
        self.events = self.anchor = self.stream = None
        self.anchor_ns = self.anchor_error_ns = None
        if device is not None and torch.device(device).type == "cuda":
            # The events go on the device and the stream current at arm.
            self.device = torch.device("cuda", torch.cuda.current_device())
            if torch.device(device).index not in (None, self.device.index):
                raise ValueError(f"the span log records on the current "
                                 f"device, {self.device}, not {device}")
            self.stream = torch.cuda.current_stream(self.device)
            self.events = [torch.cuda.Event(enable_timing=True)
                           for _ in range(2 * cap)]
            self._anchor()

    def _anchor(self) -> None:
        import torch

        torch.cuda.synchronize(self.device)
        for _ in range(_ANCHOR_TRIES):
            ev = torch.cuda.Event(enable_timing=True)
            before = time.perf_counter_ns()
            ev.record(self.stream)
            while not ev.query():
                pass
            after = time.perf_counter_ns()
            err = (after - before) // 2
            if self.anchor_error_ns is None or err < self.anchor_error_ns:
                self.anchor, self.anchor_error_ns = ev, err
                self.anchor_ns = before + err

    def open(self, name: str) -> int:
        t = time.perf_counter_ns()
        if self.step >= self.max_steps or self.n >= self.cap:
            self.dropped += 1
            return -1
        i = self.n
        self.n += 1
        self.names[i], self.parents[i], self.step_of[i] = \
            name, self.current, self.step
        self.host[2 * i] = t
        if self.events is not None:
            self.events[2 * i].record(self.stream)
        self.current = i
        return i

    def close(self, i: int, name: str) -> None:
        if i >= 0:
            self.host[2 * i + 1] = time.perf_counter_ns()
            if self.events is not None:
                self.events[2 * i + 1].record(self.stream)
            self.current = self.parents[i]
        if name == scopes.STAGE_STEP:
            self.step += 1

    def collect(self, rank: int) -> Log:
        dev = [None] * (2 * self.n)
        if self.events is not None:
            import torch
            torch.cuda.synchronize(self.device)
            dev = [self.anchor_ns + round(
                self.anchor.elapsed_time(self.events[j]) * 1e6)
                for j in range(2 * self.n)]
        out = [Span(self.names[i], self.parents[i], self.step_of[i],
                    self.host[2 * i], self.host[2 * i + 1],
                    dev[2 * i], dev[2 * i + 1]) for i in range(self.n)]
        return Log(out, self.dropped, min(self.step, self.max_steps),
                   self.anchor_error_ns, rank)


# The last log disarmed, still collectable.
_last: Optional[_Recorder] = None


def arm(max_steps: int, device=None) -> None:
    """Start a log with room for ``max_steps`` steps on ``device`` (a CUDA
    device records device times; None or the CPU does not), and arm the
    collective counters. Synchronises the device."""
    if scopes.SPAN_LOG is not None:
        raise RuntimeError("the span log is already armed")
    if max_steps < 1:
        raise ValueError("max_steps must be positive")
    rec = _Recorder(max_steps, device)
    counters.arm()
    scopes.SPAN_LOG = rec


def disarm() -> None:
    """Stop recording and counting; what was recorded stays collectable
    until the next :func:`arm`, and the counts readable."""
    global _last
    if scopes.SPAN_LOG is None:
        return
    _last = scopes.SPAN_LOG
    scopes.SPAN_LOG = None
    counters.disarm()


def collect() -> Log:
    """The records of the armed log, or of the last one disarmed, once
    every span of it has closed (after the logged steps). The one call
    that synchronises (with the card, to read the events)."""
    rec = scopes.SPAN_LOG or _last
    if rec is None:
        raise RuntimeError("the span log was never armed")
    import torch.distributed as dist
    return rec.collect(dist.get_rank() if dist.is_initialized() else 0)


def gather(log: Log, group=None) -> Optional[List[Log]]:
    """Every rank's log on the group's first rank, in rank order (None on
    the others): one ``all_gather_object``. Call it after the logged
    steps, on every rank."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return [log]
    logs: List[Optional[Log]] = [None] * dist.get_world_size(group)
    dist.all_gather_object(logs, log, group=group)
    return logs if dist.get_rank(group) == 0 else None


# -- reading a log -----------------------------------------------------------

def self_ns(log: Log) -> List[int]:
    """Each span's self time on the host: its duration less its
    children's."""
    out = [s.host_ns for s in log.spans]
    for s in log.spans:
        if s.parent >= 0:
            out[s.parent] -= s.host_ns
    return out


def _steps(log: Log) -> List[int]:
    return sorted({s.step for s in log.spans if s.name == scopes.STAGE_STEP})


def per_step_ms(log: Log, name: str) -> Optional[float]:
    """Mean host ms a logged step spends in spans named ``name``, or None
    where no step holds one."""
    steps = _steps(log)
    durs = [s.host_ns for s in log.spans
            if s.name == name and s.step in steps]
    if not durs:
        return None
    return sum(durs) / 1e6 / len(steps)


def host_lead_ms(log: Log) -> Optional[float]:
    """Median over the logged steps of the device end less the host end of
    ``grace/step``: how far the host runs ahead of the card. Near 0, the
    card waits on the host. None off the card."""
    leads = [s.device_end_ns - s.host_end_ns for s in log.spans
             if s.name == scopes.STAGE_STEP and s.device_end_ns is not None]
    return statistics.median(leads) / 1e6 if leads else None


def arrival_skew_ms(logs: Sequence[Log],
                    name: str = scopes.STAGE_BACKWARD) -> Optional[float]:
    """Median over the steps every rank logged of the spread over the ranks
    of the end of their ``name`` span (``grace/backward``): how long the
    first rank to reach the step's collectives waits on the last. The
    device end on the card; off it, the host end, where the work ends."""
    ends = []
    for log in logs:
        by_step = {}
        for s in log.spans:
            if s.name == name:
                end = s.device_end_ns if s.device_end_ns is not None \
                    else s.host_end_ns
                by_step[s.step] = max(end, by_step.get(s.step, end))
        ends.append(by_step)
    if len(ends) < 2:
        return None
    common = set.intersection(*(set(e) for e in ends))
    if not common:
        return None
    return statistics.median(
        max(e[k] for e in ends) - min(e[k] for e in ends)
        for k in common) / 1e6
