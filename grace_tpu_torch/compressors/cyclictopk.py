"""Cyclic Top-K: one shared strided index window a step; counterpart of
the JAX package's ``compressors/cyclictopk.py``.

The window is ``(start + i·stride) mod numel`` for ``i < k``, with ``stride
= numel // k`` and ``start`` drawn from the leaf's key
(``randint(fold(0x5ca1e), (), 0, numel)``). The key is the same on every
rank and rotates with the step, so every rank keeps the same lanes and
payloads sum exactly (``payload_algebra='exact'``); error feedback
re-injects what the window missed.

The JAX package keeps the indices in ctx. Here ctx holds the key, numel,
shape and dtype, and ``decompress`` rebuilds the window from the key, as
``randomk.py`` does: the shard-parallel communicators decode other ranks'
shard payloads with their own ctx, which is sound only for a ctx free of
tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from grace_tpu_torch.compressors.topk import static_k
from grace_tpu_torch.core import Compressor, Ctx, LeafKey, Payload, State
from grace_tpu_torch.ops.sparse import scatter_dense

SALT = 0x5ca1e


@dataclasses.dataclass(frozen=True)
class CyclicTopKCompressor(Compressor):
    # The index set is rank-identical: payloads sum to the sum's payload.
    payload_algebra = "exact"
    supports_hop_requant = False

    compress_ratio: float = 0.01

    def schedule(self, rng: LeafKey, numel: int, device) -> torch.Tensor:
        """The k int32 indices of this (step, leaf)'s window."""
        k = static_k(numel, self.compress_ratio)
        start = rng.fold(SALT).randint((), 0, numel, device)
        stride = max(1, numel // k)
        offsets = torch.arange(k, dtype=torch.int32, device=device) * stride
        return (start + offsets) % numel

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        flat = x.reshape(-1)
        numel = flat.numel()
        values = flat[self.schedule(rng, numel, flat.device).long()]
        return (values,), (rng, numel, tuple(x.shape), x.dtype), state

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        (values,) = payload
        rng, numel, shape, dtype = ctx
        return scatter_dense(values.to(dtype),
                             self.schedule(rng, numel, values.device),
                             numel, shape)
