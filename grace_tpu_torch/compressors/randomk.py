"""Random-K sparsification with rank-shared indices; counterpart of the
JAX package's ``compressors/randomk.py``.

``k = static_k(n, ratio)`` indices are drawn without replacement from the
leaf's key (``LeafKey.permutation``), which every rank holds alike for the
same (step, leaf, fold). Every rank therefore keeps the same entries, only
their values travel, and payloads sum exactly
(``payload_algebra='exact'``).

The JAX package keeps the indices in ctx. Here ctx holds only static data
(the key, numel and shape), and :meth:`RandomKCompressor.decompress` draws
the indices again from the key, as the count sketch does with its hashes:
the shard-parallel communicators decode other ranks' shard payloads with
their own ctx, which is sound only for a ctx free of data.

The permutation comes from the key's ``torch.Generator``, so its bits
differ from ``jax.random.permutation``'s; tests that compare the two
packages give the port JAX's indices through the key.
"""

from __future__ import annotations

import dataclasses

import torch

from grace_tpu_torch.compressors.topk import static_k
from grace_tpu_torch.core import Compressor, Ctx, LeafKey, Payload, State
from grace_tpu_torch.ops.sparse import scatter_dense


@dataclasses.dataclass(frozen=True)
class RandomKCompressor(Compressor):
    compress_ratio: float = 0.3
    # Shared indices: payload values of every rank sum exactly.
    payload_algebra = "exact"
    # Linear codec: the exact payload-space ring path applies; no requant.
    supports_hop_requant = False

    def _indices(self, rng: LeafKey, numel: int, device) -> torch.Tensor:
        k = static_k(numel, self.compress_ratio)
        return rng.permutation(numel, device)[:k]

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        flat = x.reshape(-1)
        numel = flat.numel()
        values = flat[self._indices(rng, numel, flat.device)]
        return (values,), (rng, numel, tuple(x.shape)), state

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        (values,) = payload
        rng, numel, shape = ctx
        return scatter_dense(values, self._indices(rng, numel, values.device),
                             numel, shape)
