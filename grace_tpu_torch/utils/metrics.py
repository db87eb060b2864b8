"""Bytes-on-wire accounting; counterpart of the JAX package's
``utils/metrics.py`` (``payload_nbytes``, ``wire_report`` and its
``CompressionReport``/``LeafReport``; ``guard_report`` and
``debug_nan_residuals`` wait for the resilience slice).

The count is of *logical* payload bytes: what the codec's payload tensors
hold, not what a collective pads them to.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple

import torch

from grace_tpu_torch.core import Compressor, LeafKey

__all__ = ["LeafReport", "CompressionReport", "payload_nbytes",
           "wire_report"]


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
