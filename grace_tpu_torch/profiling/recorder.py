"""Runtime performance recorder: step times, kernel builds, memory
watermarks, GraceState footprints; the counterpart of the JAX package's
``profiling/recorder.py``.

:class:`ProfileRecorder` emits, through the telemetry sinks
(``telemetry.JSONLSink`` and the rest, so one JSONL artifact carries the
whole run):

* **step-time percentiles** (``perf_step_times``: mean/p50/p90/p99/max over
  the steady window of a :class:`~grace_tpu_torch.utils.profiling.
  StepTimer`), stamped ``sync_missing`` when the timer only measured
  launches;
* **kernel builds** (``perf_compile``, then ``perf_retrace`` when the
  count grows): the port's steps run eagerly, with no ``torch.compile`` and
  so no compile cache to watch; what stalls a step the way a JAX retrace
  does is a kernel library built or loaded at its first launch
  (``ops._build``), which :func:`compile_count` counts. JAX's retrace
  check (a jit cache that grows) has no counterpart, and every
  ``perf_step_times`` record says so in ``retrace_check``;
* **device-memory watermarks** (``perf_memory``: ``bytes_in_use`` and
  ``peak_bytes_in_use`` from ``torch.cuda.memory_stats``, the caching
  allocator's ``allocated_bytes.all.current`` and ``.peak``; absent off
  the card, as JAX's are on backends without stats);
* **GraceState footprints** (``perf_state_footprint``) checked against the
  codec's expected model.

The footprint functions: the JAX package holds the whole mesh's state in
one global array, whose per-rank fields (``mem``, ``comp``, the rings)
carry a leading world axis. The port holds one rank's state a process, so
the functions take ``world`` and scale the per-rank bytes by it: the
numbers are JAX's integers for the same configuration and world. The
replicated bookkeeping (``count``, the key, ``fallback``, ``audit``,
``adapt``) counts once, at JAX's widths.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from grace_tpu_torch.utils.profiling import StepTimer

__all__ = ["ProfileRecorder", "compile_count", "device_memory_watermarks",
           "grace_state_footprint", "expected_state_footprint",
           "check_state_footprint"]

RETRACE_CHECK = ("none: eager torch steps keep no compile cache; kernel "
                 "builds are counted instead (perf_compile/perf_retrace)")


def compile_count(step_fn=None) -> int:
    """The kernel libraries this process has built or loaded
    (``ops._build.library`` and ``host_library``; 0 before the first
    kernel launch and on the CPU, where the wrappers run their plain
    versions). ``step_fn`` is the JAX package's argument, for its jit
    cache; the port's eager steps have none, so it is not read."""
    from grace_tpu_torch.ops import _build
    return (_build.library.cache_info().currsize
            + _build.host_library.cache_info().currsize)


def device_memory_watermarks(devices=None) -> Optional[Dict[str, int]]:
    """Max ``bytes_in_use`` / ``peak_bytes_in_use`` over ``devices`` (CUDA
    devices or indices; None: the current one, the only card this
    process allocates on), from the caching allocator's
    ``torch.cuda.memory_stats`` (``allocated_bytes.all.current`` and
    ``.peak``). None without CUDA, as JAX's is on backends without
    stats."""
    if not torch.cuda.is_available():
        return None
    devices = (list(devices) if devices is not None
               else [torch.cuda.current_device()])
    in_use, peak = [], []
    for d in devices:
        stats = torch.cuda.memory_stats(d)
        if "allocated_bytes.all.current" in stats:
            in_use.append(int(stats["allocated_bytes.all.current"]))
        if "allocated_bytes.all.peak" in stats:
            peak.append(int(stats["allocated_bytes.all.peak"]))
    if not in_use and not peak:
        return None
    out: Dict[str, int] = {"n_devices": len(devices)}
    if in_use:
        out["bytes_in_use"] = max(in_use)
    if peak:
        out["peak_bytes_in_use"] = max(peak)
    return out


def _nbytes(tree) -> int:
    from grace_tpu_torch.transform import _state_tensors
    return sum(t.numel() * t.element_size() for t in _state_tensors(tree))


def grace_state_footprint(tree, world: int = 1) -> Dict[str, int]:
    """Bytes held by every GraceState in ``tree`` (a GraceState, a guard's
    state, a train state, or dicts, lists and tuples of them), by
    component: ``mem`` (residuals), ``comp`` (compressor state, e.g.
    PowerSGD's Q), ``telem`` (the telemetry and watch rings), each this
    rank's bytes times ``world``, and ``bookkeeping`` (the replicated
    scalars)."""
    from grace_tpu_torch.resilience.consensus import (_ADAPT_HOST_NBYTES,
                                                      _AUDIT_NBYTES,
                                                      _GRACE_SCALAR_NBYTES,
                                                      _nodes)
    from grace_tpu_torch.transform import GraceState

    graces = _nodes(tree, GraceState)
    mem = sum(_nbytes(g.mem) for g in graces) * world
    comp = sum(_nbytes(g.comp) for g in graces) * world
    telem = sum(_nbytes([g.telem, g.watch]) for g in graces) * world
    # At JAX's widths (the consensus view's); the controller's two float32
    # statistics are 4 bytes each.
    book = sum(_GRACE_SCALAR_NBYTES
               + (_AUDIT_NBYTES if g.audit is not None else 0)
               + (_ADAPT_HOST_NBYTES + 8 if g.adapt is not None else 0)
               for g in graces)
    return {"grace_states": len(graces),
            "mem_bytes": mem, "comp_bytes": comp, "telem_bytes": telem,
            "bookkeeping_bytes": book,
            "total_bytes": mem + comp + telem + book}


def expected_state_footprint(grace_or_tx, params, world: int = 1
                             ) -> Dict[str, int]:
    """The configuration's expected footprint for ``params`` (a mapping of
    names to tensors) at ``world`` ranks: the state ``init`` builds, on
    the meta device (shapes and dtypes, no memory, no collective), counted
    by :func:`grace_state_footprint`. ``grace_or_tx`` is a ``Grace``
    bundle, a transform or a guarded chain."""
    if hasattr(grace_or_tx, "transform"):
        # An explicit layout: detecting one is a collective of the Grace's
        # group, and the footprint does not depend on it.
        from grace_tpu_torch.core import Topology
        tx = dataclasses.replace(
            grace_or_tx, topology=grace_or_tx.topology or Topology()
        ).transform(seed=0)
    else:
        tx = grace_or_tx
    meta = {k: torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")
            for k, v in params.items()}
    return grace_state_footprint(tx.init(meta), world)


def check_state_footprint(state, grace_or_tx, params, world: int = 1
                          ) -> Dict[str, Any]:
    """Live GraceState bytes against the expected model at ``world``:
    ``matches`` compares the three per-codec components exactly (a
    mismatch means the state was built under another codec, fusion,
    telemetry configuration or world)."""
    live = grace_state_footprint(state, world)
    model = expected_state_footprint(grace_or_tx, params, world)
    matches = all(live[k] == model[k]
                  for k in ("mem_bytes", "comp_bytes", "telem_bytes"))
    return {"live": live, "model": model, "matches": matches}


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

class ProfileRecorder:
    """Record step times, kernel builds and memory through a telemetry
    sink (module docstring).

    Usage::

        rec = ProfileRecorder(sink, every=25, step_fn=step)
        for i, batch in enumerate(batches):
            with rec.step():
                state, loss = step(state, batch)
                rec.sync_on(loss)
            rec.update(i)
        rec.flush(len(batches) - 1)

    ``step_fn`` (optional) arms the kernel-build check (:func:`compile_count`
    at every update); without it only timing and memory records are
    emitted. Between flushes the recorder reads no device value: the timer
    waits on the step's own output, the memory stats are an allocator
    query and the build count a host-side cache size.
    """

    def __init__(self, sink=None, every: int = 20, warmup: int = 2,
                 step_fn=None, percentiles=(50, 90, 99)):
        if every < 1:
            raise ValueError(f"flush interval must be >= 1; got {every}")
        self.sink = sink
        self.every = every
        self.percentiles = tuple(percentiles)
        self.timer = StepTimer(warmup=warmup)
        self.retraces = 0        # kernel builds after the first observation
        self.flushes = 0
        self._step_fn = step_fn
        self._compiles: Optional[int] = None

    # -- timing (delegates to the StepTimer) ----------------------------------
    def step(self):
        return self.timer.step()

    def sync_on(self, out) -> None:
        self.timer.sync_on(out)

    # -- per-iteration hook -------------------------------------------------
    def update(self, step: int) -> List[dict]:
        """Call once per loop iteration (after the step). Checks the kernel
        builds every iteration, so a build is attributed to the step that
        made it, and emits the windowed records on every ``every``-th
        call."""
        records = self._check_retrace(step)
        if (step + 1) % self.every == 0:
            records.extend(self.flush(step))
        return records

    def _check_retrace(self, step: int) -> List[dict]:
        if self._step_fn is None:
            return []
        count = compile_count(self._step_fn)
        records: List[dict] = []
        if self._compiles is None:
            self._compiles = count
            if count > 0:
                records.append({"event": "perf_compile", "step": step,
                                "cache_size": count})
        elif count > self._compiles:
            self.retraces += count - self._compiles
            self._compiles = count
            records.append({"event": "perf_retrace", "step": step,
                            "cache_size": count,
                            "retraces": self.retraces})
        self._emit(records)
        return records

    def flush(self, step: int) -> List[dict]:
        """Emit the windowed records: step-time percentiles and (on the
        card) the memory watermark."""
        records: List[dict] = []
        if len(self.timer):
            arr = self.timer.steady * 1e3
            rec = {"event": "perf_step_times", "step": step,
                   "n_steps": int(arr.size),
                   "mean_ms": float(arr.mean()),
                   "max_ms": float(arr.max())}
            for q in self.percentiles:
                rec[f"p{q:g}_ms"] = float(np.percentile(arr, q))
            if self.timer.measured_async_dispatch:
                # launch-only timings: the number is not a step time
                rec["sync_missing"] = True
            if self.timer.failed_steps:
                rec["failed_steps"] = self.timer.failed_steps
            rec["retrace_check"] = RETRACE_CHECK
            records.append(rec)
        mem = device_memory_watermarks()
        if mem is not None:
            records.append({"event": "perf_memory", "step": step, **mem})
        self.flushes += 1
        self._emit(records)
        return records

    def record_state_footprint(self, state, grace_or_tx=None, params=None,
                               world: int = 1, step: int = -1) -> dict:
        """One-shot GraceState footprint record (the footprint is fixed at
        init, so once per run is enough). With ``grace_or_tx`` + ``params``
        the live bytes are checked against the expected model and the
        record carries ``footprint_matches``."""
        rec: Dict[str, Any] = {"event": "perf_state_footprint", "step": step}
        if grace_or_tx is not None and params is not None:
            checked = check_state_footprint(state, grace_or_tx, params,
                                            world=world)
            rec.update(checked["live"])
            rec.update({f"model_{k}": v for k, v in checked["model"].items()
                        if k.endswith("_bytes")})
            rec["footprint_matches"] = checked["matches"]
        else:
            rec.update(grace_state_footprint(state, world))
        self._emit([rec])
        return rec

    def _emit(self, records: List[dict]) -> None:
        if self.sink is not None:
            for rec in records:
                self.sink.write(rec)

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()
