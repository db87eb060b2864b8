"""Bytes-on-wire accounting; counterpart of the JAX package's
``utils/metrics.py`` (``payload_nbytes``, ``wire_report`` and its
``CompressionReport``/``LeafReport``), and the guard's health readers
``guard_report`` and ``debug_nan_residuals``, each one device-to-host
transfer, and ``HostCopy``, the one such transfer that the guard's flags
and the adaptive controller's window statistics take without waiting.

The count is of *logical* payload bytes: what the codec's payload tensors
hold, not what a collective pads them to.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple

import torch

from grace_tpu_torch.core import Compressor, LeafKey
from grace_tpu_torch.ops.fake import is_fake

__all__ = ["LeafReport", "CompressionReport", "payload_nbytes",
           "wire_report", "guard_report", "debug_nan_residuals", "HostCopy"]


class HostCopy:
    """A device tensor on its way to the host: on CUDA a copy into pinned
    memory that does not block, with an event recorded after it; on the
    CPU the tensor itself. :meth:`wait` waits for that copy only. A fake
    CUDA tensor (the static auditor's trace) takes a copy to the host that
    does not block, which the trace records."""

    def __init__(self, x: torch.Tensor):
        if x.device.type == "cuda" and is_fake(x):
            self.host, self.event = x.to("cpu", non_blocking=True), None
        elif x.device.type == "cuda":
            self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self.host.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = x, None

    def wait(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        return self.host


def _struct(x) -> Tuple[Tuple[int, ...], torch.dtype]:
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    shape, dtype = x
    return tuple(shape), dtype


def payload_nbytes(compressor: Compressor, x) -> int:
    """Logical wire bytes of ``compressor``'s payload for one tensor.

    ``x`` is a tensor, or a ``(shape, dtype)`` pair. An analytic
    ``Compressor.wire_nbytes`` wins. Otherwise zeros of the shape and dtype
    are encoded on the CPU, where every kernel wrapper runs its plain
    version, and the payload tensors' bytes are summed: torch's ``meta``
    device cannot run the kernels, and the payload's shapes do not depend
    on the values.
    """
    shape, dtype = _struct(x)
    declared = compressor.wire_nbytes(shape, dtype)
    if declared is not None:
        return int(declared)
    zeros = torch.zeros(shape, dtype=dtype)
    payload, _, _ = compressor.compress(zeros, compressor.init_state(zeros),
                                        LeafKey(0, 0, 0))
    return sum(math.prod(t.shape) * t.element_size() for t in payload)


@dataclasses.dataclass(frozen=True)
class LeafReport:
    path: str
    dense_bytes: int
    wire_bytes: int

    @property
    def ratio(self) -> float:
        return self.wire_bytes / max(self.dense_bytes, 1)


@dataclasses.dataclass(frozen=True)
class CompressionReport:
    leaves: Tuple[LeafReport, ...]

    @property
    def dense_bytes(self) -> int:
        return sum(l.dense_bytes for l in self.leaves)

    @property
    def wire_bytes(self) -> int:
        return sum(l.wire_bytes for l in self.leaves)

    @property
    def ratio(self) -> float:
        """wire/dense: smaller is better; 1.0 means no compression."""
        return self.wire_bytes / max(self.dense_bytes, 1)

    def summary(self) -> Dict[str, Any]:
        return {"dense_bytes": self.dense_bytes,
                "wire_bytes": self.wire_bytes,
                "ratio": round(self.ratio, 6),
                "n_leaves": len(self.leaves)}

    def __str__(self) -> str:
        s = self.summary()
        return (f"CompressionReport(dense={s['dense_bytes']:,}B, "
                f"wire={s['wire_bytes']:,}B, ratio={s['ratio']:.4f}, "
                f"leaves={s['n_leaves']})")


def _keystr(name: str) -> str:
    """JAX's ``keystr`` of the leaf named ``name``: ``"layers.0.ff1.b"`` →
    ``"['layers'][0]['ff1']['b']"`` (a part of digits is a list index, as
    in ``transform.leaf_order``)."""
    return "".join(f"[{p}]" if p.isdecimal() else f"[{p!r}]"
                   for p in name.split("."))


def wire_report(compressor: Compressor,
                grads: Mapping[str, Any]) -> CompressionReport:
    """Per-leaf and total bytes on the wire for a mapping of dotted names
    to tensors or ``(shape, dtype)`` pairs, in the JAX flatten order."""
    from grace_tpu_torch.transform import leaf_order

    wire: Dict[Tuple, int] = {}          # one encode a distinct leaf shape
    leaves = []
    for name in leaf_order(grads):
        s = _struct(grads[name])
        if s not in wire:
            wire[s] = payload_nbytes(compressor, s)
        leaves.append(LeafReport(path=_keystr(name),
                                 dense_bytes=math.prod(s[0]) * s[1].itemsize,
                                 wire_bytes=wire[s]))
    return CompressionReport(leaves=tuple(leaves))


def guard_report(state: Any) -> Dict[str, Any]:
    """The step guard's health in ``state`` (a ``TrainState``, a
    ``GuardState`` or any tree holding one)::

        {"step", "notfinite_count", "last_bad_step", "consecutive",
         "fallback_remaining", "fallback_active"}

    in one device-to-host transfer: the counters a loop logs each step
    (``utils.logging.GuardMonitor``) and weighs at save time
    (``Checkpointer.save(..., good=...)``). Empty without a guard."""
    from grace_tpu_torch.resilience.guard import GuardState
    from grace_tpu_torch.telemetry.reader import collect

    found = collect(state, GuardState)
    if not found:
        return {}
    nf, lb, cs, fr, st = found[0].counters().tolist()
    return {"step": st, "notfinite_count": nf, "last_bad_step": lb,
            "consecutive": cs, "fallback_remaining": fr,
            "fallback_active": fr > 0}


def debug_nan_residuals(state: Any) -> Dict[str, Dict[str, int]]:
    """NaN and ±Inf census over every floating tensor of a state tree:
    ``{path: {"nan": n, "inf": m}}`` for the tensors that hold any (paths
    as ``checkpoint.state_leaves`` names them: ``grace/mem/3``,
    ``model/fc.w``); an empty dict means clean. The chunk Top-K kernel
    keeps a NaN gradient lane in the residual rather than on the wire, so
    a poisoned residual is invisible in the loss. Every count comes back
    in ONE device-to-host transfer."""
    from grace_tpu_torch.checkpoint import state_leaves

    paths, counts = [], []
    for path, (leaf, _) in state_leaves(state).items():
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            paths.append(path)
            counts.append(torch.stack([torch.isnan(leaf).sum(),
                                       torch.isinf(leaf).sum()]))
    # Host tensors (Adam's step) are read where they are; the device's
    # counts come back stacked, in one transfer.
    host = [c.tolist() if c.device.type == "cpu" else None for c in counts]
    on_device = [i for i, h in enumerate(host) if h is None]
    if on_device:
        for i, c in zip(on_device, torch.stack(
                [counts[i] for i in on_device]).tolist()):
            host[i] = c
    return {p: {"nan": int(c[0]), "inf": int(c[1])}
            for p, c in zip(paths, host) if c[0] or c[1]}
