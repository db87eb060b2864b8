"""Natural compression: stochastic rounding to a power of two; counterpart
of the JAX package's ``compressors/natural.py``.

Each float32 word's exponent is rounded up with probability
``mantissa / 2^23`` (a ``LeafKey.randint`` below ``2^23 − 1`` per element,
compared with the mantissa), clipped to the biased exponents ``[18,
145]``, and sent with the sign as one byte: ``sign << 7 | (exp − 18)``;
code 0 decodes to zero. The bit arithmetic runs on int32 views (torch has
no shifts on uint32 on the CPU), with every right shift masked, since
``>>`` on int32 is arithmetic.
"""

from __future__ import annotations

import dataclasses

import torch

from grace_tpu_torch.core import Compressor, Ctx, LeafKey, Payload, State

MANTISSA_BITS = 23
MANTISSA_MASK = (1 << MANTISSA_BITS) - 1
MIN_BIASED_EXP = 18
MAX_BIASED_EXP = 145


@dataclasses.dataclass(frozen=True)
class NaturalCompressor(Compressor):
    # Sign/exponent codes: adding two ranks' codes is meaningless.
    payload_algebra = None
    supports_hop_requant = False

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        flat = x.reshape(-1).to(torch.float32)
        bits = flat.view(torch.int32)
        sign = (bits >> 31) & 1
        exp = (bits >> MANTISSA_BITS) & 0xFF
        mantissa = bits & MANTISSA_MASK
        rnd = rng.randint(flat.shape, 0, MANTISSA_MASK, flat.device)
        exp = torch.where(mantissa > rnd, exp + 1, exp)
        exp = torch.clamp(exp, MIN_BIASED_EXP, MAX_BIASED_EXP)
        code = (sign << 7) | (exp - MIN_BIASED_EXP)
        return (code.to(torch.uint8),), (tuple(x.shape), x.dtype), state

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        (code,) = payload
        shape, dtype = ctx
        sign = code >= 128
        exp_code = (code & 0x7F).to(torch.int32)
        mag = ((exp_code + MIN_BIASED_EXP) << MANTISSA_BITS).view(
            torch.float32)
        out = torch.where(sign, -mag, mag)
        out = torch.where(exp_code >= 1, out,
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device))
        return out.reshape(shape).to(dtype)
