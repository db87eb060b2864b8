"""Profiling helpers: trace capture and honest step timing; the counterpart
of the JAX package's ``utils/profiling.py``.

``trace(logdir)`` captures a ``torch.profiler`` session (CPU ranges and,
on the card, CUDA kernels) and writes it as a Chrome trace that
:func:`grace_tpu_torch.profiling.find_latest_trace` finds and
:func:`~grace_tpu_torch.profiling.analyze_trace` reads. ``StepTimer``
gives steady-state step times that wait for the device.

The runtime recorder built on top of this (percentiles, kernel-build
events, memory watermarks, sink emission) is
:class:`grace_tpu_torch.profiling.ProfileRecorder`.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Iterator, List

import numpy as np
import torch

__all__ = ["trace", "StepTimer"]


@contextlib.contextmanager
def trace(logdir: str, device="cuda") -> Iterator[object]:
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when ``device`` is a CUDA device) and write the capture under
    ``logdir`` as ``<worker>.<ns>.pt.trace.json.gz``
    (``tensorboard_trace_handler``). Yields the profiler. On a machine
    without CUDA, pass ``device="cpu"``: the default raises there, as every
    entry point of the port does."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    from grace_tpu_torch.parallel import resolve_device

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(logdir,
                                                            use_gzip=True))
    prof.start()
    try:
        yield prof
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()


def _wait(target) -> None:
    """Wait until every CUDA tensor in ``target`` (a tensor, or a dict,
    list or tuple of them) is computed; a CPU tensor is ready when its op
    returns."""
    from grace_tpu_torch.data import _leaves
    for dev in {t.device for t in _leaves(target)
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Per-step wall-clock stats that wait for the device.

    Usage::

        timer = StepTimer(warmup=2)
        for batch in batches:
            with timer.step():
                state, loss = train_step(state, batch)
                timer.sync_on(loss)     # wait on a step OUTPUT

    ``mean_sec``/``p50_sec`` skip the warmup steps (kernel builds, cuDNN
    autotuning, allocator growth).

    Without ``sync_on`` the timer measures only the *launch* of the step —
    the host enqueueing CUDA work, not its execution — and the resulting
    "throughput" is fiction. The first such step warns once, and
    :attr:`measured_async_dispatch` stays True so downstream consumers
    (``ProfileRecorder`` stamps it on every emitted record) can flag the
    numbers. ``sync_on`` waits with ``torch.cuda.synchronize`` on the
    device of each CUDA tensor it is given.

    A step body that raises still records its timing row (wall-clock up to
    the raise) and bumps :attr:`failed_steps`.
    """

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.failed_steps = 0
        # True once any completed step was timed without a sync target:
        # the recorded times are launch-only and throughput is unusable.
        self.measured_async_dispatch = False
        self._times: List[float] = []
        self._sync_target = None
        self._warned_async = False

    def sync_on(self, out) -> None:
        self._sync_target = out

    def _note_async_dispatch(self) -> None:
        self.measured_async_dispatch = True
        if not self._warned_async:
            self._warned_async = True
            warnings.warn(
                "StepTimer.step() completed without sync_on(): the recorded "
                "time covers only the launch, not device execution — "
                "call timer.sync_on(<a step output>) inside the step block "
                "(CUDA runs asynchronously; without a wait the step "
                "'finishes' when its kernels are queued).",
                RuntimeWarning, stacklevel=3)

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        except BaseException:
            # Record the partial row (the slow step that died is the one a
            # postmortem needs to see) but never let a failed step's sync
            # target poison the next one.
            self._sync_target = None
            self._times.append(time.perf_counter() - t0)
            self.failed_steps += 1
            raise
        if self._sync_target is not None:
            _wait(self._sync_target)
            self._sync_target = None
        else:
            self._note_async_dispatch()
        self._times.append(time.perf_counter() - t0)

    def __len__(self) -> int:
        return len(self._times)

    @property
    def steady(self) -> np.ndarray:
        if not self._times:
            raise RuntimeError("StepTimer has no recorded steps")
        return np.asarray(self._times[self.warmup:] or self._times)

    @property
    def mean_sec(self) -> float:
        return float(self.steady.mean())

    @property
    def p50_sec(self) -> float:
        return float(np.median(self.steady))

    def percentile_sec(self, q: float) -> float:
        """Steady-state percentile, e.g. ``percentile_sec(99)``."""
        return float(np.percentile(self.steady, q))

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.mean_sec

    def confidence95(self, items_per_step: int) -> float:
        """±1.96σ half-width on items/sec (the reference's reporting
        convention)."""
        per_step = items_per_step / self.steady
        return float(1.96 * per_step.std())
