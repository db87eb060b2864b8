"""Loggers and timers for training loops; counterpart of the JAX package's
``utils/logging.py`` (its ``Timer``, ``TableLogger``, ``TSVLogger``,
rank-0 printing and run provenance). The rank is the ``torch.distributed``
rank (0 outside a process group), where JAX reads the process index.
``GuardMonitor`` prints the step guard's transitions, ``ConsensusMonitor``
the consensus audit's.
"""

from __future__ import annotations

import functools
import os
import subprocess
import time
from typing import Callable, Mapping, Optional, Sequence, TextIO

import torch
import torch.distributed as dist

__all__ = ["Timer", "TableLogger", "TSVLogger", "GuardMonitor",
           "ConsensusMonitor", "localtime",
           "rank_zero_only", "rank_zero_print", "run_provenance",
           "git_commit"]


def localtime() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())


def _rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Decorator: run ``fn`` on rank 0 only."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if _rank() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped


@rank_zero_only
def rank_zero_print(*args, **kwargs) -> None:
    print(*args, **kwargs)


class Timer:
    """Segment timer: each call returns the seconds since the previous one.

    ``sync`` runs before every reading, so that queued device work is
    counted: pass ``torch.cuda.synchronize`` on the card.
    ``include_in_total=False`` leaves a segment (an evaluation) out of
    ``total_time``, the DAWNBench rule."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.sync = sync or (lambda: None)
        self.sync()
        self._last = time.perf_counter()
        self.total_time = 0.0

    def __call__(self, include_in_total: bool = True) -> float:
        self.sync()
        now = time.perf_counter()
        delta = now - self._last
        self._last = now
        if include_in_total:
            self.total_time += delta
        return delta


class TableLogger:
    """Aligned-column stdout logger, its header taken from the first row's
    keys. A missing key prints a blank cell; a key the header never saw is
    skipped, with a one-time ``# new columns (ignored): ...`` line."""

    def __init__(self, width: int = 12, stream: Optional[TextIO] = None):
        self.width = width
        self.stream = stream
        self._keys: Optional[Sequence[str]] = None
        self._announced: set = set()

    def _emit(self, line: str) -> None:
        print(line, file=self.stream)

    def append(self, row: Mapping[str, object]) -> None:
        if self._keys is None:
            self._keys = list(row.keys())
            self._emit(" ".join(f"{k:>{self.width}s}" for k in self._keys))
        new = [k for k in row if k not in self._keys
               and k not in self._announced]
        if new:
            self._announced.update(new)
            self._emit(f"# new columns (ignored): {', '.join(new)}")
        cells = []
        for k in self._keys:
            if k not in row:
                cells.append(" " * self.width)
                continue
            v = row[k]
            if isinstance(v, float):
                cells.append(f"{v:{self.width}.4f}")
            else:
                cells.append(f"{v!s:>{self.width}s}")
        self._emit(" ".join(cells))


class TSVLogger:
    """DAWNBench-format log: ``epoch\\thours\\ttop1Accuracy`` rows, from
    rows with ``epoch``, ``total time`` (seconds) and ``test acc`` (a
    fraction). ``provenance`` entries lead as ``# key: value`` lines
    (:func:`run_provenance` gives the standard set)."""

    HEADER = "epoch\thours\ttop1Accuracy"

    def __init__(self, provenance: Optional[Mapping[str, object]] = None):
        self._prov = dict(provenance or {})
        self._rows = [self.HEADER]

    def append(self, row: Mapping[str, object]) -> None:
        epoch = row["epoch"]
        hours = float(row["total time"]) / 3600.0
        acc = float(row["test acc"]) * 100.0
        self._rows.append(f"{epoch}\t{hours:.8f}\t{acc:.2f}")

    def __str__(self) -> str:
        prov = [f"# {k}: {v}" for k, v in self._prov.items()]
        return "\n".join(prov + self._rows)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(str(self) + "\n")


class GuardMonitor:
    """Emit the step guard's transitions: skipped steps, the fallback
    window opening and closing.

    Feed it the per-step dict of ``utils.metrics.guard_report``; it prints
    (rank 0 only, through :func:`rank_zero_print` by default) only when
    something changed, so a healthy run stays silent::

        mon = GuardMonitor()
        for i, batch in enumerate(batches):
            state, loss = step(state, batch)
            mon.update(i, guard_report(state))

    ``sink`` (a ``grace_tpu_torch.telemetry`` sink) also receives each
    transition as ``{"event": "guard_skip" | "guard_fallback_engaged" |
    "guard_rearmed", "step": ..., **report}``, beside the telemetry rows.
    Re-arm fires on the first report whose ``fallback_active`` is False
    after a True."""

    def __init__(self, printer: Optional[Callable[..., None]] = None,
                 sink=None):
        self._print = printer or rank_zero_print
        self._sink = sink
        self._last: Optional[dict] = None

    def _event(self, name: str, step: int,
               report: Mapping[str, object]) -> None:
        if self._sink is not None:
            self._sink.write({"event": name, "step": step, **report})

    def update(self, step: int, report: Mapping[str, object]) -> None:
        if not report:
            return
        prev, self._last = self._last, dict(report)
        if prev is None:
            return
        if report["notfinite_count"] > prev["notfinite_count"]:
            self._print(f"[guard] step {step}: non-finite/exploding update "
                        f"skipped (total={report['notfinite_count']}, "
                        f"consecutive={report['consecutive']})")
            self._event("guard_skip", step, report)
        if report["fallback_active"] and not prev["fallback_active"]:
            self._print(f"[guard] step {step}: dense fallback engaged for "
                        f"{report['fallback_remaining']} steps")
            self._event("guard_fallback_engaged", step, report)
        if prev["fallback_active"] and not report["fallback_active"]:
            self._print(f"[guard] step {step}: compression re-armed")
            self._event("guard_rearmed", step, report)


class ConsensusMonitor:
    """Emit the consensus audit's *transitions*: repairs and escalations.

    The :class:`GuardMonitor` twin for
    :mod:`grace_tpu_torch.resilience.consensus`. Feed it the per-step dict
    of ``resilience.audit_report(state)``; it prints (rank 0 only) and
    writes to ``sink`` only when a counter moved, so a healthy run stays
    silent::

        mon = ConsensusMonitor(sink=jsonl_sink)
        for i, batch in enumerate(batches):
            state, loss = step(state, batch)
            mon.update(i, audit_report(state))

    Sink records: ``{"event": "consensus_repair" |
    "consensus_escalation", "step": ..., **report}``, in the same stream as
    the telemetry rows and guard events."""

    def __init__(self, printer: Optional[Callable[..., None]] = None,
                 sink=None):
        self._print = printer or rank_zero_print
        self._sink = sink
        self._last: Optional[dict] = None

    def _event(self, name: str, step: int,
               report: Mapping[str, object]) -> None:
        if self._sink is not None:
            self._sink.write({"event": name, "step": step, **report})

    def update(self, step: int, report: Mapping[str, object]) -> None:
        if not report:
            return
        prev, self._last = self._last, dict(report)
        if prev is None:
            return
        if report["repairs"] > prev["repairs"]:
            self._print(f"[consensus] step {step}: replica divergence on "
                        f"rank {report['last_divergent_rank']} repaired "
                        f"(total repairs={report['repairs']})")
            self._event("consensus_repair", step, report)
        if report["escalations"] > prev["escalations"]:
            self._print(f"[consensus] step {step}: rank "
                        f"{report['last_divergent_rank']} re-diverged — "
                        f"escalating to dense fallback "
                        f"(total escalations={report['escalations']})")
            self._event("consensus_escalation", step, report)


def git_commit() -> Optional[str]:
    """The short git commit of this checkout, or None (outside one, or
    without git). Resolved against the package's own directory."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    except (OSError, subprocess.SubprocessError):
        return None
    rev = out.stdout.strip()
    return rev if out.returncode == 0 and rev else None


def run_provenance(data: str, **extra: object) -> dict:
    """The provenance block of a training-curve file: ``data`` names the
    data honestly (``"synthetic"`` or ``"real:<path>"``); the platform, the
    device, the device count, a UTC time stamp and the git commit (when
    there is one) are read from the live environment; ``extra`` adds
    anything of the run's own."""
    cuda = torch.cuda.is_available()
    prov = {
        "data": data,
        "platform": "gpu" if cuda else "cpu",
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "world_size": (dist.get_world_size()
                       if dist.is_available() and dist.is_initialized()
                       else 1),
        "generated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    rev = git_commit()
    if rev is not None:
        prov["git_commit"] = rev
    prov.update(extra)
    return prov
