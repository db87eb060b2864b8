"""EF-SignSGD, error-feedback sign SGD; counterpart of the JAX package's
``compressors/efsignsgd.py``.

The payload is the mean |x| and the sign bits packed 8 to a byte
(``ops.packing.pack_bits``, as in the JAX package: not the ``sign_pack``
kernel, which the JAX codec does not use). The aggregate sums the scaled
signs and divides by the learning rate, undoing the ``lr`` that the paired
``memories.EFSignSGDMemory`` applied in ``compensate``; ``average`` is
False.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from grace_tpu_torch.core import Compressor, Ctx, LeafKey, Payload, State
from grace_tpu_torch.ops.packing import pack_bits, unpack_bits


@dataclasses.dataclass(frozen=True)
class EFSignSGDCompressor(Compressor):
    average = False
    # (mean, packed signs): sign bytes do not sum, and the scale has no
    # meaning over a partial sum.
    payload_algebra = None
    supports_hop_requant = False

    lr: float = 0.1

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        flat = x.reshape(-1)
        mean = torch.mean(flat.abs())
        packed = pack_bits(flat >= 0)
        return (mean, packed), (flat.numel(), tuple(x.shape), x.dtype), state

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        mean, packed = payload
        numel, shape, dtype = ctx
        signs = unpack_bits(packed, numel).to(dtype) * 2 - 1
        return (mean * signs).reshape(shape)

    def aggregate(self, stacked: torch.Tensor) -> torch.Tensor:
        # ``sum / lr``: XLA compiles the division by a constant into a
        # multiplication by its float32 reciprocal.
        return torch.sum(stacked, dim=0) * float(
            np.float32(1.0) / np.float32(self.lr))
