"""Identity (no-op) compressor; counterpart of the JAX ``compressors/none.py``."""

from __future__ import annotations

import dataclasses

import torch

from grace_tpu_torch.core import Compressor, Ctx, LeafKey, Payload, State


@dataclasses.dataclass(frozen=True, kw_only=True)
class NoneCompressor(Compressor):
    """Pass-through: the payload is the tensor itself. ``average`` is
    keyword-only, as in the JAX package."""

    average: bool = True
    # The identity payload IS the tensor: sums compose exactly.
    payload_algebra = "exact"
    # Linear codec: a requant round-trip would add nothing but work.
    supports_hop_requant = False

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        return (x,), None, state

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        (x,) = payload
        return x
