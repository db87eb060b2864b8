"""Profiler-trace analysis: attribute device time to pipeline stages; the
counterpart of the JAX package's ``profiling/trace_analysis.py``.

Every pipeline stage runs under a ``grace/...`` range
(:mod:`grace_tpu_torch.telemetry.scopes`, a ``torch.profiler``
``record_function``), so a profiler capture carries the stage vocabulary.
This module reads a capture back into spans and answers:

* **where did the step's device time go, per stage?** Each device span is
  charged its *self* time (nested children subtracted) to the canonical
  stage its name or scope matches (``telemetry.scopes.match_stage``, the
  longest-prefix rule), so the stage table sums exactly to the total;
* **compute vs collective**: op-name classification of the collective
  families (XLA's spellings and NCCL's and gloo's: ``ncclDevKernel_
  AllReduce...``, ``c10d::allgather_``);
* **overlap fraction**: the share of collective time hidden under
  concurrent compute on the same device, from interval unions of the device
  timelines (not host wall-clock);
* **step-time percentiles** from the trace's step markers (JAX's ``Steps``
  lane, or ``torch.profiler``'s ``ProfilerStep#N`` ranges).

The input is a Chrome trace: ``torch.profiler``'s ``export_chrome_trace``
or ``tensorboard_trace_handler``'s ``*.pt.trace.json[.gz]``, and the JAX
package's ``trace.json.gz`` layout, which parses to the same spans (its
canned fixtures give JAX's numbers here).

**Attributing device work to stages.** In a JAX capture the device ops
carry their ``grace/...`` scope in their names, or in the HLO metadata of
the sibling ``xplane.pb`` (JAX's ``hlo_scope_map``/``enrich_spans``/
``parse_xplane``). A CUDA kernel's name carries no scope, and the port
attributes it with the profiler's own events instead, in
:func:`parse_chrome_trace`:

1. **launch correlation**: a kernel (or memcpy, memset) event's
   ``args.correlation`` names the ``cuda_runtime``/``cuda_driver`` event
   that launched it; the innermost ``grace/...`` range (``user_annotation``)
   around the launch is the kernel's stage: on the launching thread, else
   the one the process has open at that moment (autograd launches the
   backward's kernels from threads of its own, while the main thread sits
   in ``grace/forward_backward``);
2. **containment**: a CPU op takes the innermost range around it by the
   same rule (the only rule on a CPU-only capture); a device span without
   a launch, the innermost ``gpu_user_annotation`` range of its stream.

The ranges themselves are not device work: ``gpu_user_annotation`` spans
(the ranges projected onto a stream) and ``ProfilerStep#N`` markers are
left out of the device totals, so the total equals the sum of the kernels'
durations on each stream, what ``key_averages``' CUDA rows sum.

The XPlane protobuf half of the JAX module is XLA's and is not ported:
``torch.profiler`` writes no XSpace, and its Chrome trace already carries
what the HLO metadata gave JAX (the ranges and the launch correlation).
"""

from __future__ import annotations

import bisect
import dataclasses
import glob
import gzip
import json
import os
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from grace_tpu_torch.telemetry.scopes import match_stage

__all__ = ["Span", "TraceAnalysis", "load_trace_events", "parse_chrome_trace",
           "analyze_trace", "analyze_spans", "interval_union_us",
           "overlap_us", "find_latest_trace", "UNATTRIBUTED", "STEP_LANE"]

# Stage bucket for device spans outside the grace/... vocabulary (the model
# forward/backward kernels launched under no named range, etc.). Kept
# explicit so the stage table still sums to the total.
UNATTRIBUTED = "(unattributed)"

# Lane (thread) name the XLA profiler uses for per-step markers.
STEP_LANE = "Steps"

# The name prefix of torch.profiler's per-step ranges (``prof.step()``).
STEP_PREFIX = "ProfilerStep#"

# Op-name substrings that mark a span as wire time: XLA's spellings
# (all-gather.3, collective-permute-start), JAX's primitive names, and
# NCCL's kernels and c10d's ops (ncclDevKernel_AllGather_RING_LL,
# c10d::allreduce_).
_COLLECTIVE_TOKENS = (
    "all-gather", "all_gather", "all-reduce", "all_reduce", "allreduce",
    "all-to-all", "all_to_all", "collective-permute", "collective_permute",
    "ppermute", "reduce-scatter", "reduce_scatter", "psum",
    "collective-broadcast", "send-done", "recv-done",
    "allgather", "reducescatter", "alltoall", "sendrecv", "nccl",
)

# torch.profiler's event categories.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
_RANGE_CATS = ("user_annotation", "gpu_user_annotation")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass(frozen=True)
class Span:
    """One complete event on one timeline: ``[ts, ts+dur)`` microseconds.
    ``cat`` is the torch.profiler event category (empty in JAX's traces)."""

    name: str
    ts: float                 # µs since trace epoch
    dur: float                # µs
    device: str = ""          # process name, e.g. "GPU 0" / "/device:TPU:0"
    lane: str = ""            # thread name, e.g. "stream 7" / "XLA Ops"
    scope: str = ""           # extra scope path (args metadata), if any
    cat: str = ""             # torch.profiler category, if any

    @property
    def end(self) -> float:
        return self.ts + self.dur

    def stage(self) -> str:
        """Canonical grace stage of this span (name first, scope second)."""
        return match_stage(self.name) or match_stage(self.scope)

    def is_collective(self) -> bool:
        text = f"{self.name} {self.scope}".lower()
        return any(tok in text for tok in _COLLECTIVE_TOKENS)

    def is_range(self) -> bool:
        """A torch.profiler range (``record_function``), not an op."""
        return self.cat in _RANGE_CATS

    def is_step_marker(self) -> bool:
        return self.lane == STEP_LANE or self.name.startswith(STEP_PREFIX)


# ---------------------------------------------------------------------------
# Chrome trace format
# ---------------------------------------------------------------------------

class _Ranges:
    """The ``grace/...`` ranges of one lane, for innermost-range lookups."""

    def __init__(self, spans: List[Span]):
        self.spans = sorted(spans, key=lambda s: (s.ts, -s.dur))
        self.starts = [s.ts for s in self.spans]

    def innermost(self, ts: float, end: float) -> Optional[Span]:
        """The latest-starting range that holds ``[ts, end]`` (ranges of a
        lane nest, so that is the innermost one)."""
        i = bisect.bisect_right(self.starts, ts)
        while i > 0:
            i -= 1
            r = self.spans[i]
            if r.end >= end:
                return r
        return None


def _attribute(spans: List[Span], corr: List[Optional[int]]) -> List[Span]:
    """Give every stage-less span of a torch.profiler capture the stage of
    the ``grace/...`` range that launched or holds it (module docstring):
    its scope becomes that range's name."""
    cpu_lane: Dict[Tuple[str, str], List[Span]] = {}
    cpu_proc: Dict[str, List[Span]] = {}
    gpu_lane: Dict[Tuple[str, str], List[Span]] = {}
    for s in spans:
        if not (s.is_range() and match_stage(s.name)):
            continue
        if s.cat == "gpu_user_annotation":
            gpu_lane.setdefault((s.device, s.lane), []).append(s)
        else:
            cpu_lane.setdefault((s.device, s.lane), []).append(s)
            cpu_proc.setdefault(s.device, []).append(s)
    cpu_lane = {k: _Ranges(v) for k, v in cpu_lane.items()}
    cpu_proc = {k: _Ranges(v) for k, v in cpu_proc.items()}
    gpu_lane = {k: _Ranges(v) for k, v in gpu_lane.items()}

    def on_host(device, lane, ts, end):
        # The range of the span's own thread, else the process's range open
        # over it: backward kernels are launched from autograd's threads,
        # inside the main thread's grace/forward_backward.
        for table, key in ((cpu_lane, (device, lane)), (cpu_proc, device)):
            hit = table[key].innermost(ts, end) if key in table else None
            if hit is not None:
                return hit
        return None

    launches: Dict[int, Span] = {}
    for s, c in zip(spans, corr):
        if c is not None and s.cat in _LAUNCH_CATS:
            launches[c] = s
    out = []
    for s, c in zip(spans, corr):
        if s.stage() or s.is_step_marker() or s.is_range() or not s.cat:
            out.append(s)
            continue
        launch = launches.get(c) if s.cat in _DEVICE_CATS else None
        if launch is not None:
            hit = on_host(launch.device, launch.lane, launch.ts, launch.ts)
        elif s.cat in _DEVICE_CATS:
            lane = gpu_lane.get((s.device, s.lane))
            hit = lane.innermost(s.ts, s.end) if lane else None
        else:
            hit = on_host(s.device, s.lane, s.ts, s.end)
        if hit is not None:
            s = dataclasses.replace(
                s, scope=f"{s.scope} {hit.name}".strip())
        out.append(s)
    return out


def parse_chrome_trace(doc: Mapping) -> List[Span]:
    """Chrome-trace-format dict → spans, with pid/tid names resolved from
    the ``process_name``/``thread_name`` metadata events, and a
    torch.profiler capture's kernels attributed to their ``grace/...``
    ranges (module docstring)."""
    events = doc.get("traceEvents", [])
    pid_names: Dict[object, str] = {}
    tid_names: Dict[Tuple[object, object], str] = {}
    for e in events:
        if e.get("ph") != "M":
            continue
        args = e.get("args") or {}
        if e.get("name") == "process_name":
            pid_names[e.get("pid")] = str(args.get("name", e.get("pid")))
        elif e.get("name") == "thread_name":
            tid_names[(e.get("pid"), e.get("tid"))] = str(
                args.get("name", e.get("tid")))
    spans: List[Span] = []
    corr: List[Optional[int]] = []
    for e in events:
        if e.get("ph") != "X" or not e.get("dur"):
            continue
        pid, tid = e.get("pid"), e.get("tid")
        args = e.get("args") or {}
        # Scope metadata surfaces in different arg keys across profiler
        # versions (JAX's long_name carries the full HLO metadata path).
        scope = " ".join(str(v) for k, v in sorted(args.items())
                         if isinstance(v, str)
                         and k in ("name", "long_name", "tf_op", "scope",
                                   "hlo_op", "group_name"))
        c = args.get("correlation")
        corr.append(c if isinstance(c, int) else None)
        spans.append(Span(name=str(e.get("name", "")),
                          ts=float(e["ts"]), dur=float(e["dur"]),
                          device=pid_names.get(pid, f"pid {pid}"),
                          lane=tid_names.get((pid, tid), f"tid {tid}"),
                          scope=scope, cat=str(e.get("cat", "") or "")))
    if any(s.cat for s in spans):
        spans = _attribute(spans, corr)
    return spans


def load_trace_events(path: str) -> List[Span]:
    """Load spans from a Chrome-trace file (``.json`` or ``.json.gz``).
    An XSpace protobuf (``.xplane.pb``) is XLA's format, which
    torch.profiler does not write: it raises ``ValueError``."""
    lower = path.lower()
    if lower.endswith(".pb") or ".xplane" in lower:
        raise ValueError(
            f"{path}: XSpace protobufs are XLA's capture format; the port "
            "reads torch.profiler's Chrome traces (*.trace.json[.gz]) only")
    opener = gzip.open if lower.endswith(".gz") else open
    with opener(path, "rt") as f:
        return parse_chrome_trace(json.load(f))


def find_latest_trace(logdir: str) -> Optional[str]:
    """Newest Chrome trace under ``logdir`` (what
    ``utils.profiling.trace`` and ``tensorboard_trace_handler`` write:
    ``<worker>.<ns>.pt.trace.json[.gz]``; JAX's ``plugins/profile/<run>/
    *.trace.json.gz`` too)."""
    paths = []
    for pattern in ("**/*.trace.json.gz", "**/*.trace.json"):
        paths.extend(glob.glob(os.path.join(logdir, pattern),
                               recursive=True))
    return max(paths, key=os.path.getmtime) if paths else None


# ---------------------------------------------------------------------------
# interval math (all µs)
# ---------------------------------------------------------------------------

def interval_union_us(intervals: Iterable[Tuple[float, float]]
                      ) -> List[Tuple[float, float]]:
    """Merge ``(start, end)`` intervals into a disjoint sorted union."""
    ivs = sorted((s, e) for s, e in intervals if e > s)
    out: List[Tuple[float, float]] = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _measure(union: Sequence[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in union)


def overlap_us(a: Sequence[Tuple[float, float]],
               b: Sequence[Tuple[float, float]]) -> float:
    """Measure of the intersection of two interval unions (each already
    disjoint + sorted, as :func:`interval_union_us` returns)."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _self_times(spans: List[Span]) -> List[float]:
    """Self time of each span (dur minus time covered by nested children on
    the same timeline). Complete events on one thread nest properly; a
    malformed partial overlap clamps at zero rather than going negative.
    Per-stage sums of self time add up exactly to the union measure of the
    lane — the invariant that makes the stage table sum to the total."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i].ts, -spans[i].dur))
    child = [0.0] * len(spans)
    stack: List[int] = []
    for i in order:
        s = spans[i]
        while stack and s.ts >= spans[stack[-1]].end - 1e-9:
            stack.pop()
        if stack:
            child[stack[-1]] += s.dur
        stack.append(i)
    return [max(0.0, spans[i].dur - child[i]) for i in range(len(spans))]


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TraceAnalysis:
    """Stage attribution + overlap + step stats of one profiler trace."""

    path: Optional[str]
    n_spans: int
    devices: List[str]
    device_lanes_detected: bool
    total_us: float                       # total device self time
    stage_us: Dict[str, float]            # canonical stage → self µs
    compute_us: float
    collective_us: float
    overlap_us: float                     # collective ∩ compute, device time
    step_times_us: List[float]

    @property
    def overlap_fraction(self) -> Optional[float]:
        """Share of collective device time hidden under concurrent compute
        on the same device; None when the trace has no collective time."""
        if self.collective_us <= 0.0:
            return None
        return self.overlap_us / self.collective_us

    def step_percentiles_ms(self) -> Optional[Dict[str, float]]:
        if not self.step_times_us:
            return None
        arr = np.asarray(self.step_times_us) * 1e-3
        return {"n": len(self.step_times_us),
                "mean_ms": float(arr.mean()),
                "p50_ms": float(np.percentile(arr, 50)),
                "p90_ms": float(np.percentile(arr, 90)),
                "p99_ms": float(np.percentile(arr, 99)),
                "max_ms": float(arr.max())}

    def as_dict(self) -> dict:
        return {
            "trace": self.path,
            "n_spans": self.n_spans,
            "devices": self.devices,
            "device_lanes_detected": self.device_lanes_detected,
            "total_device_ms": round(self.total_us * 1e-3, 6),
            "stages_ms": {k: round(v * 1e-3, 6)
                          for k, v in sorted(self.stage_us.items(),
                                             key=lambda kv: -kv[1])},
            "compute_ms": round(self.compute_us * 1e-3, 6),
            "collective_ms": round(self.collective_us * 1e-3, 6),
            "overlap_ms": round(self.overlap_us * 1e-3, 6),
            "overlap_fraction": (None if self.overlap_fraction is None
                                 else round(self.overlap_fraction, 6)),
            "step_times": self.step_percentiles_ms(),
        }

    def render(self) -> str:
        out = []
        dev = ", ".join(self.devices) or "(no device lanes — all spans)"
        out.append(f"devices: {dev}")
        out.append(f"spans: {self.n_spans}   total device time: "
                   f"{self.total_us / 1e3:.3f} ms")
        out.append("")
        out.append(f"  {'stage':<28s}{'ms':>12s}{'share':>9s}")
        for name, us in sorted(self.stage_us.items(), key=lambda kv: -kv[1]):
            share = us / self.total_us if self.total_us else 0.0
            out.append(f"  {name:<28s}{us / 1e3:>12.3f}{share:>8.1%}")
        out.append(f"  {'TOTAL':<28s}{self.total_us / 1e3:>12.3f}"
                   f"{'100.0%':>9s}")
        out.append("")
        out.append(f"  compute: {self.compute_us / 1e3:.3f} ms   "
                   f"collective: {self.collective_us / 1e3:.3f} ms")
        if self.overlap_fraction is None:
            out.append("  overlap: n/a (no collective time in trace)")
        else:
            out.append(
                f"  overlap: {self.overlap_us / 1e3:.3f} ms of collective "
                f"time hidden under compute — overlap fraction "
                f"{self.overlap_fraction:.1%} (device timelines; the bench "
                "projection model assumes 0%)")
        sp = self.step_percentiles_ms()
        if sp:
            out.append(f"  steps: n={sp['n']}  mean {sp['mean_ms']:.3f} ms  "
                       f"p50 {sp['p50_ms']:.3f}  p90 {sp['p90_ms']:.3f}  "
                       f"p99 {sp['p99_ms']:.3f}  max {sp['max_ms']:.3f}")
        return "\n".join(out)


def _is_device(span: Span) -> bool:
    """A device span: on a process named like JAX's ``/device:TPU:0``, or
    of a GPU category. torch 2.11's profiler (on an H100) files the kernels
    under the program's own process (``python3``) on ``stream N`` threads,
    so for its captures the category decides."""
    low = span.device.lower()
    return ("/device:" in low or "tpu" in low or "gpu" in low
            or span.cat in _DEVICE_CATS)


def analyze_spans(spans: List[Span],
                  path: Optional[str] = None) -> TraceAnalysis:
    """Attribute a span list. Device lanes are JAX's ``/device:...``
    processes or torch.profiler's GPU streams; when the trace marks none (a
    CPU capture), every lane is analyzed and the result says so. Step
    markers (the ``Steps`` lane, ``ProfilerStep#N``) give the step-time
    samples and the ranges projected onto a GPU stream are left out of op
    attribution (they *cover* the ops; charging both would double-count)."""
    # The profiler's own session span ("PyTorch Profiler (0)") covers
    # the whole capture and is no op.
    spans_in = [s for s in spans if s.cat != "Trace"]
    device_spans = [s for s in spans_in if _is_device(s)]
    detected = bool(device_spans)
    if not detected:
        device_spans = spans_in
    markers = [s for s in device_spans if s.lane == STEP_LANE] or [
        s for s in spans_in if s.name.startswith(STEP_PREFIX)
        and s.cat != "gpu_user_annotation"]
    step_times = [s.dur for s in markers]
    op_spans = [s for s in device_spans if not s.is_step_marker()
                and not (detected and s.cat == "gpu_user_annotation")]

    by_lane: Dict[Tuple[str, str], List[Span]] = {}
    for s in op_spans:
        by_lane.setdefault((s.device, s.lane), []).append(s)

    stage_us: Dict[str, float] = {}
    total = 0.0
    coll_by_device: Dict[str, List[Tuple[float, float]]] = {}
    comp_by_device: Dict[str, List[Tuple[float, float]]] = {}
    for (device, _lane), lane_spans in by_lane.items():
        selfs = _self_times(lane_spans)
        for s, self_us in zip(lane_spans, selfs):
            stage = s.stage() or UNATTRIBUTED
            stage_us[stage] = stage_us.get(stage, 0.0) + self_us
            total += self_us
            bucket = (coll_by_device if s.is_collective()
                      else comp_by_device)
            bucket.setdefault(device, []).append((s.ts, s.end))

    collective = overlap = compute = 0.0
    for device in set(coll_by_device) | set(comp_by_device):
        cu = interval_union_us(coll_by_device.get(device, []))
        pu = interval_union_us(comp_by_device.get(device, []))
        collective += _measure(cu)
        compute += _measure(pu)
        overlap += overlap_us(cu, pu)

    return TraceAnalysis(
        path=path,
        n_spans=len(spans),
        devices=sorted({s.device for s in device_spans}),
        device_lanes_detected=detected,
        total_us=total,
        stage_us=stage_us,
        compute_us=compute,
        collective_us=collective,
        overlap_us=overlap,
        step_times_us=step_times)


def analyze_trace(path: str) -> TraceAnalysis:
    """Load + analyze one Chrome trace (see :func:`load_trace_events`);
    pass a directory to analyze its newest capture."""
    if os.path.isdir(path):
        found = find_latest_trace(path)
        if found is None:
            raise FileNotFoundError(
                f"no *.trace.json[.gz] under {path}")
        path = found
    return analyze_spans(load_trace_events(path), path=path)
