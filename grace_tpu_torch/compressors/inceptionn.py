"""INCEPTIONN-style error-bounded float compression; counterpart of the
JAX package's ``compressors/inceptionn.py``.

Each value whose exponent lies in ``[eb_exp, 127)`` becomes a 16-bit code:
the sign, then the mantissa behind a marker bit, shifted right by ``127 −
exp`` (at most 14), so that the decoder finds the exponent from the
marker's position. Values under the error bound send 0; values of 1.0 and
above send the largest code unless the fixed-capacity float32 overflow
lane (the largest-|x| entries) carries them exactly.

The bit arithmetic runs on int32 words (torch has no shifts on uint32 on
the CPU), with every right shift of a possibly negative word masked. The
uint16 codes are made and read through int16 views (torch has little
uint16 arithmetic) and travel as their bytes.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from grace_tpu_torch.core import Compressor, Ctx, LeafKey, Payload, State

MANT_BITS = 23
MARKER = 1 << 22
MAX_CODE = 0x7FFF          # marker at shift 1, every mantissa bit set


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """``floor(log2(x))`` of int32 ``x`` in ``[1, 2^24)``, exactly, from
    its float32 exponent."""
    return ((x.to(torch.float32).view(torch.int32) >> MANT_BITS) & 0xFF) \
        - 127


@dataclasses.dataclass(frozen=True)
class InceptionNCompressor(Compressor):
    tensors_size_are_same = False
    # Code words do not sum: no algebra.
    payload_algebra = None
    supports_hop_requant = False

    error_bound: float = 1e-4
    overflow_ratio: float = 0.0625

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        flat = x.reshape(-1).to(torch.float32)
        numel = flat.numel()
        bits = flat.view(torch.int32)
        sign = (bits >> 31) & 1
        exp = (bits >> MANT_BITS) & 0xFF
        mantissa = bits & ((1 << MANT_BITS) - 1)
        eb_exp = max(113, 127 + int(math.floor(math.log2(self.error_bound))))
        n_shift = torch.clamp(127 - exp, 1, 14)
        body = ((mantissa >> 1) | MARKER) >> n_shift
        code = (sign << 15) | (body >> 7)
        in_band = (exp >= eb_exp) & (exp < 127)
        v16 = torch.where(in_band, code, torch.zeros_like(code))
        v16 = torch.where(exp >= 127, (sign << 15) | MAX_CODE, v16)
        cap = max(1, int(numel * self.overflow_ratio))
        mags, idx = torch.topk(flat.abs(), min(cap, numel))
        v32 = torch.where(mags >= 1.0, flat[idx],
                          torch.zeros((), dtype=flat.dtype,
                                      device=flat.device))
        # uint16 words through int16 bits: a view, no uint16 arithmetic.
        return (v16.to(torch.int16).view(torch.uint16), v32,
                idx.to(torch.int32)), (numel, tuple(x.shape), x.dtype), state

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        v16, v32, idx = payload
        numel, shape, dtype = ctx
        code = v16.view(torch.int16).to(torch.int32) & 0xFFFF
        sign = code >> 15
        body = code & MAX_CODE
        p = floor_log2(torch.clamp_min(body, 1))
        mant = (body ^ (torch.ones_like(p) << p)) << (MANT_BITS - p)
        fbits = (sign << 31) | ((112 + p) << MANT_BITS) | mant
        vals = torch.where(body == 0,
                           torch.zeros((), dtype=torch.float32,
                                       device=code.device),
                           fbits.view(torch.float32))
        idx = idx.long()
        out = vals.clone()
        out[idx] = torch.where(v32 != 0, v32, vals[idx])
        return out.reshape(shape).to(dtype)
