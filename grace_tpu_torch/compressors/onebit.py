"""1-bit SGD: the sign mask and the mean of each side; counterpart of the
JAX package's ``compressors/onebit.py``.

The payload is the negative mask packed 8 to a byte
(``ops.packing.pack_bits``), the mean of the negative entries and the mean
of the others; a side with no entry sends its sum, 0.
"""

from __future__ import annotations

import dataclasses

import torch

from grace_tpu_torch.core import Compressor, Ctx, LeafKey, Payload, State
from grace_tpu_torch.ops.packing import pack_bits, unpack_bits


@dataclasses.dataclass(frozen=True)
class OneBitCompressor(Compressor):
    # (mask, mean pair): the means have no meaning summed across ranks.
    payload_algebra = None
    supports_hop_requant = False

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        flat = x.reshape(-1)
        numel = flat.numel()
        zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
        mask0 = flat < 0
        num0 = torch.sum(mask0).to(flat.dtype)
        sum0 = torch.sum(torch.where(mask0, flat, zero))
        mean0 = torch.where(num0 > 0, sum0 / torch.clamp_min(num0, 1), sum0)
        num1 = numel - num0
        sum1 = torch.sum(torch.where(mask0, zero, flat))
        mean1 = torch.where(num1 > 0, sum1 / torch.clamp_min(num1, 1), sum1)
        return (pack_bits(mask0), mean0, mean1), (numel, tuple(x.shape)), \
            state

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        packed, mean0, mean1 = payload
        numel, shape = ctx
        mask0 = unpack_bits(packed, numel)
        return torch.where(mask0, mean0, mean1).reshape(shape)
