"""TernGrad: stochastic ternarisation; counterpart of the JAX package's
``compressors/terngrad.py``.

Clip at ``clip_factor`` standard deviations (the population one, as
``jnp.std``), scale by the largest clipped magnitude, and keep each entry
with probability ``|x|/scale`` as ±scale. Codes 0 (dropped), 1 (+1) and 2
(−1) are packed four to a byte (``ops.packing.pack_2bit``). The noise is
``LeafKey.uniform`` times ``max(scale, 1e-30)``, which is JAX's
``uniform(key, shape, maxval=max(scale, 1e-30))`` bit for bit given the
same uniforms.
"""

from __future__ import annotations

import dataclasses

import torch

from grace_tpu_torch.core import Compressor, Ctx, LeafKey, Payload, State
from grace_tpu_torch.ops.packing import pack_2bit, unpack_2bit


@dataclasses.dataclass(frozen=True)
class TernGradCompressor(Compressor):
    # Per-rank scale: no algebra; no validated re-encode of a partial sum.
    payload_algebra = None
    supports_hop_requant = False

    clip_factor: float = 2.5

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        flat = x.reshape(-1)
        c = self.clip_factor * torch.std(flat, correction=0)
        clipped = torch.clamp(flat, -c, c)
        abs_g = clipped.abs()
        scalar = torch.max(abs_g)
        rnd = rng.uniform(flat.shape, flat.device).to(flat.dtype) \
            * torch.clamp_min(scalar, 1e-30)
        keep = rnd < abs_g
        one, two = (torch.ones((), dtype=torch.uint8, device=flat.device),
                    torch.full((), 2, dtype=torch.uint8, device=flat.device))
        codes = torch.where(keep, torch.where(clipped >= 0, one, two),
                            torch.zeros_like(one))
        return (pack_2bit(codes), scalar), \
            (flat.numel(), tuple(x.shape), x.dtype), state

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        packed, scalar = payload
        numel, shape, dtype = ctx
        codes = unpack_2bit(packed, numel)
        tern = torch.zeros(numel, dtype=dtype, device=packed.device)
        tern = torch.where(codes == 1, torch.ones_like(tern), tern)
        tern = torch.where(codes == 2, -torch.ones_like(tern), tern)
        return (tern * scalar).reshape(shape)
