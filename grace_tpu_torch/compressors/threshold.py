"""Hard-threshold sparsification; counterpart of the JAX package's
``compressors/threshold.py``.

Every entry with |x| above ``threshold`` should travel, but a payload's
shape may depend only on the input's shape, so the payload is a fixed
capacity of ``int(capacity_ratio·n)`` lanes: the largest-|x| entries, with
the lanes not above the threshold carrying 0. :meth:`calibrated` sets the
capacity from the density measured on a sample gradient.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from grace_tpu_torch.core import Compressor, Ctx, LeafKey, Payload, State
from grace_tpu_torch.ops.sparse import scatter_dense


@dataclasses.dataclass(frozen=True)
class ThresholdCompressor(Compressor):
    tensors_size_are_same = False
    # (values, per-rank indices) under a capacity mask: no algebra.
    payload_algebra = None
    supports_hop_requant = False

    threshold: float = 0.01
    capacity_ratio: float = 0.25

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        flat = x.reshape(-1)
        numel = flat.numel()
        cap = max(1, int(numel * self.capacity_ratio))
        mags, indices = torch.topk(flat.abs(), cap)
        values = torch.where(mags > float(np.float32(self.threshold)),
                             flat[indices],
                             torch.zeros((), dtype=flat.dtype,
                                         device=flat.device))
        return (values, indices.to(torch.int32)), (numel, tuple(x.shape)), \
            state

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        values, indices = payload
        numel, shape = ctx
        return scatter_dense(values, indices, numel, shape)

    def calibrated(self, sample: torch.Tensor, safety: float = 1.5,
                   floor_ratio: float = 0.001) -> "ThresholdCompressor":
        """A copy whose ``capacity_ratio`` is the density of entries above
        the threshold in ``sample`` (a representative gradient) times
        ``safety``, at least ``floor_ratio`` and one entry, at most 1.
        Measured once, at set-up: a density that drifts past the headroom
        drops only the smallest selected entries, which error feedback
        brings back."""
        density = float(torch.mean(
            (sample.abs() > float(np.float32(self.threshold))).to(
                torch.float32)))
        ratio = min(1.0, max(density * safety, floor_ratio,
                             1.0 / max(1, sample.numel())))
        return dataclasses.replace(self, capacity_ratio=ratio)
