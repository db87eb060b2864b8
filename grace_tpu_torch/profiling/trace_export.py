"""Chrome-trace *export*; the counterpart of the JAX package's
``profiling/trace_export.py``.

:mod:`~grace_tpu_torch.profiling.trace_analysis` parses profiler
artifacts; the flight recorder and multi-host capture shipping need the
inverse — take :class:`~grace_tpu_torch.profiling.trace_analysis.Span`
lists (possibly one per host), merge them, and emit a Chrome-trace JSON
that ``parse_chrome_trace`` round-trips **exactly**: device names through
``process_name`` metadata events, lanes through ``thread_name``, the
span scope through the ``args.scope`` key the parser already reads, and a
torch.profiler span's category through ``cat`` (written only when set, so
a JAX package span list gives the JAX package's document byte for byte).

Typical shipping path for a multi-host capture::

    spans = merge_host_traces({"host0": spans0, "host1": spans1})
    write_chrome_trace(spans, "EVIDENCE/capture.trace.json.gz")

after which ``load_trace_events`` / ``perf_report`` analyze the merged
per-hop/per-tier spans like any single-host trace.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

from grace_tpu_torch.profiling.trace_analysis import Span

__all__ = ["chrome_trace_doc", "write_chrome_trace", "merge_host_traces"]


def chrome_trace_doc(spans: Iterable[Span]) -> Dict[str, Any]:
    """Spans → Chrome-trace dict. Deterministic pid/tid assignment (sorted
    device / (device, lane) order) and deterministic event order so
    identical span sets produce byte-identical documents."""
    spans = sorted(spans, key=lambda s: (s.ts, s.device, s.lane, s.name,
                                         s.dur))
    devices = sorted({s.device for s in spans})
    pids = {d: i for i, d in enumerate(devices)}
    lanes = sorted({(s.device, s.lane) for s in spans})
    tids: Dict[Tuple[str, str], int] = {}
    for device, lane in lanes:
        # tids only need to be unique per pid; number within the device.
        tids[(device, lane)] = sum(1 for d, _ in tids if d == device)
    events: List[Dict[str, Any]] = []
    for device in devices:
        events.append({"ph": "M", "name": "process_name",
                       "pid": pids[device], "args": {"name": device}})
    for device, lane in lanes:
        events.append({"ph": "M", "name": "thread_name",
                       "pid": pids[device], "tid": tids[(device, lane)],
                       "args": {"name": lane}})
    for s in spans:
        ev: Dict[str, Any] = {"ph": "X", "name": s.name,
                              "ts": s.ts, "dur": s.dur,
                              "pid": pids[s.device],
                              "tid": tids[(s.device, s.lane)]}
        if s.scope:
            ev["args"] = {"scope": s.scope}
        if s.cat:
            ev["cat"] = s.cat
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(spans: Iterable[Span], path: str) -> str:
    """Write spans as a Chrome trace; gzip iff the filename says so
    (matching ``load_trace_events``'s dispatch). Atomic tmp+replace like
    every other evidence writer."""
    doc = chrome_trace_doc(spans)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    payload = json.dumps(doc)
    if path.lower().endswith(".gz"):
        # mtime=0 keeps the archive deterministic for hash-stable evidence.
        with open(tmp, "wb") as f:
            with gzip.GzipFile(fileobj=f, mode="wb", mtime=0) as gz:
                gz.write(payload.encode())
            f.flush()
            os.fsync(f.fileno())
    else:
        with open(tmp, "w") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def merge_host_traces(host_spans: Mapping[str, Iterable[Span]], *,
                      align: bool = True,
                      offsets_us: Optional[Mapping[str, float]] = None
                      ) -> List[Span]:
    """Merge per-host span lists into one timeline.

    Device names get a ``<host>/`` prefix so two hosts' ``TPU:0`` lanes
    stay distinct lanes in the merged per-hop/per-tier view. Hosts have
    no shared clock: ``align=True`` rebases each host so its earliest
    span starts at t=0 (good enough for per-stage attribution, which sums
    durations); pass measured ``offsets_us`` per host instead when a
    clock-sync estimate exists (it wins over ``align``).
    """
    merged: List[Span] = []
    for host in sorted(host_spans):
        spans = list(host_spans[host])
        if not spans:
            continue
        if offsets_us is not None and host in offsets_us:
            shift = float(offsets_us[host])
        elif align:
            shift = -min(s.ts for s in spans)
        else:
            shift = 0.0
        for s in spans:
            device = f"{host}/{s.device}" if host else s.device
            merged.append(Span(name=s.name, ts=s.ts + shift, dur=s.dur,
                               device=device, lane=s.lane, scope=s.scope,
                               cat=s.cat))
    merged.sort(key=lambda s: (s.ts, s.device, s.lane, s.name))
    return merged
