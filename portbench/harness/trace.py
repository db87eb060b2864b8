"""The traced run's profiler capture, reduced to what the per-layer
readers need.

The arithmetic is that of the port's ``profiling/trace_analysis.py``,
copied so that a later change to the program cannot move the yardstick:

* a device event (kernel, memcpy, memset) is charged to the host ranges
  open around its **launch**: its ``args.correlation`` names the
  ``cuda_runtime``/``cuda_driver`` event that launched it, and a ``grace/...``
  range (a ``user_annotation``) holds the launch if it is open at that
  moment in the same process, on any thread (autograd launches the
  backward's kernels from threads of its own while the main thread sits in
  ``grace/forward_backward``);
* busy time is the **union** of device intervals, so kernels that overlap
  (NCCL beside compute) count once;
* collective kernels are NCCL's (``nccl`` in the name).

Only events inside the benchmark's ``portbench/profiled`` range count:
that range opens after a synchronise and closes after the last profiled
step's synchronise, so its length is the traced window.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW_RANGE = "portbench/profiled"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    ts: float                 # µs
    dur: float                # µs
    launch_ts: Optional[float]
    cat: str

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclasses.dataclass(frozen=True)
class HostSpan:
    name: str
    ts: float
    dur: float
    tid: int
    cat: str

    @property
    def end(self) -> float:
        return self.ts + self.dur


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint sorted intervals covering ``intervals``."""
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


class _Open:
    """Host spans of one name set, for 'which is open at t' lookups."""

    def __init__(self, spans: Sequence[HostSpan]):
        self.spans = sorted(spans, key=lambda s: (s.ts, -s.dur))
        self.starts = [s.ts for s in self.spans]

    def innermost(self, t: float) -> Optional[HostSpan]:
        """The latest-starting span open at ``t``."""
        i = bisect.bisect_right(self.starts, t)
        while i > 0:
            i -= 1
            if self.spans[i].end >= t:
                return self.spans[i]
        return None

    def holds(self, t: float) -> bool:
        return self.innermost(t) is not None


@dataclasses.dataclass
class Trace:
    """One rank's capture, cut to the traced window."""

    window: Tuple[float, float]
    device_ops: List[DeviceOp]
    host: List[HostSpan]
    main_tid: int
    steps: int

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        return union([(max(o.ts, lo), min(o.end, hi)) for o in self.device_ops
                      if o.end > lo and o.ts < hi])

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernels(self) -> List[DeviceOp]:
        return [o for o in self.device_ops if o.cat == "kernel"]

    def ranges(self, name: str, prefix: bool = False) -> List[HostSpan]:
        """The host ranges named ``name`` (or, with ``prefix``, whose name
        starts with it)."""
        return [s for s in self.host if s.cat == "user_annotation"
                and (s.name.startswith(name) if prefix else s.name == name)]

    def launched_in(self, name: str, prefix: bool = False) -> List[DeviceOp]:
        """Device ops whose launch lies inside a ``name`` range of the
        process (nested ranges included)."""
        open_ = _Open(self.ranges(name, prefix))
        return [o for o in self.device_ops
                if o.launch_ts is not None and open_.holds(o.launch_ts)]

    def by_name(self) -> Dict[str, Tuple[float, int]]:
        """Device µs and count by op name."""
        out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for o in self.device_ops:
            out[o.name][0] += o.dur
            out[o.name][1] += 1
        return {k: (v[0], v[1]) for k, v in out.items()}

    def idle_gaps(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        gaps, t = [], lo
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        return gaps

    def host_doing(self, times: Sequence[float]) -> List[str]:
        """For each of ``times`` (ascending): the innermost ``grace/...``
        range open then; else the innermost host event of the main
        thread; else ``idle``. Both kinds nest (the ranges are the main
        thread's), so one sweep with a stack finds them."""
        grace = _sweep([s for s in self.host if s.cat == "user_annotation"
                        and s.name.startswith("grace/")], times)
        main = _sweep([s for s in self.host if s.tid == self.main_tid
                       and s.name != WINDOW_RANGE], times)
        return [g.name if g is not None
                else f"host: {m.name}" if m is not None else "idle"
                for g, m in zip(grace, main)]


def _sweep(spans: Sequence[HostSpan], times: Sequence[float]
           ) -> List[Optional[HostSpan]]:
    spans = sorted(spans, key=lambda s: (s.ts, -s.dur))
    out: List[Optional[HostSpan]] = []
    stack: List[HostSpan] = []
    i = 0
    for t in times:
        while i < len(spans) and spans[i].ts <= t:
            while stack and stack[-1].end < spans[i].ts:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def load(path: Path, steps: int) -> Trace:
    """Parse ``torch.profiler``'s exported Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = None
    launches: Dict[int, float] = {}
    raw_ops, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat == "user_annotation" and name == WINDOW_RANGE:
            window = (ts, ts + dur, e.get("tid"))
        if cat in _DEVICE_CATS:
            raw_ops.append((name, ts, dur, args.get("correlation"), cat))
        elif cat in _HOST_CATS:
            host.append(HostSpan(name, ts, dur, e.get("tid"), cat))
            if cat in _LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = ts
    if window is None:
        raise ValueError(f"no {WINDOW_RANGE!r} range in {path}")
    lo, hi, tid = window
    ops = [DeviceOp(n, ts, dur, launches.get(c), cat)
           for n, ts, dur, c, cat in raw_ops if ts + dur > lo and ts < hi]
    host = [s for s in host if s.end > lo and s.ts < hi]
    return Trace((lo, hi), ops, host, tid, steps)


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device ops that took most time, and the idle gaps summed by
    what the host was doing at each gap's start, in seconds."""
    ops = sorted(trace.by_name().items(), key=lambda kv: -kv[1][0])[:top]
    gaps: Dict[str, float] = defaultdict(float)
    idle_gaps = trace.idle_gaps()
    for name, (a, b) in zip(trace.host_doing([a for a, _ in idle_gaps]),
                            idle_gaps):
        gaps[name] += b - a
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, us / 1e6] for n, (us, _) in ops],
            "idle_gaps": [[n, us / 1e6] for n, us in idle]}
