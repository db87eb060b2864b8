"""Mergeable count sketch; counterpart of the JAX package's
``compressors/countsketch.py``.

The gradient is projected into ``rows`` sign-hash tables,
``table[r, h_r(i)] += s_r(i) · x[i]``, and each coordinate is estimated on
decode as the median over rows of ``s_r(i) · table[r, h_r(i)]``. The hash
and sign streams come from the shared per-(step, leaf) key, which every
rank holds alike, so the encode is linear across ranks: tables add exactly
in payload space (``payload_algebra='sketch'``) and one decode at the end
of the schedule pays one estimation error.

The JAX package keeps the hash tensors in ctx. Here ctx holds only static
data (the key, numel, the table width, shape and dtype), and
:meth:`CountSketchCompressor.decompress` draws the hashes again from the
key through :meth:`CountSketchCompressor._hashes`. The shard-parallel
communicators decode other ranks' shard payloads with their own ctx, which
is sound only for a ctx free of data; a ctx with no tensor in it is that by
construction.

The hashes are drawn from the key's ``torch.Generator``, so their bits
differ from JAX's threefry draws; tests that compare the two packages
give the port JAX's hashes through ``_hashes``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from grace_tpu_torch.core import Compressor, Ctx, LeafKey, Payload, State

# The sub-stream of the leaf key that the hashes come from (JAX folds the
# same constant into its key).
HASH_FOLD = 0x5CE7C


@dataclasses.dataclass(frozen=True)
class CountSketchCompressor(Compressor):
    # Linear mergeable sketches: tables add exactly across ranks and hops.
    payload_algebra = "sketch"
    # Re-sketching a partial sum is pointless: merging is exact.
    supports_hop_requant = False

    compress_ratio: float = 0.25   # total table cells per input element
    rows: int = 3                  # independent hash rows (odd: true median)

    def __post_init__(self):
        if not 0.0 < self.compress_ratio <= 1.0:
            raise ValueError(f"compress_ratio must be in (0, 1]; got "
                             f"{self.compress_ratio}")
        if self.rows < 1 or self.rows % 2 == 0:
            raise ValueError(f"rows must be a positive odd count (median "
                             f"estimation); got {self.rows}")

    def _width(self, numel: int) -> int:
        return max(1, math.ceil(self.compress_ratio * numel / self.rows))

    def _hashes(self, rng: LeafKey, numel: int, device):
        """``(idx, signs)``: int64 bucket indices in ``[0, width)`` and
        float32 ±1 signs, each ``(rows, numel)``, drawn from ``rng`` alone,
        so every rank draws the same ones for the same key."""
        gen = rng.fold(HASH_FOLD).generator(device)
        shape = (self.rows, numel)
        idx = torch.randint(0, self._width(numel), shape, generator=gen,
                            device=device)
        signs = torch.randint(0, 2, shape, generator=gen, device=device)
        return idx, signs.to(torch.float32) * 2 - 1

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        shape = tuple(x.shape)
        flat = x.reshape(-1).float()
        numel = flat.numel()
        width = self._width(numel)
        idx, signs = self._hashes(rng, numel, flat.device)
        table = torch.zeros(self.rows, width, dtype=torch.float32,
                            device=flat.device)
        table.scatter_add_(1, idx, signs * flat)
        return (table,), (rng, numel, width, shape, x.dtype), state

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        (table,) = payload
        rng, numel, _, shape, dtype = ctx
        idx, signs = self._hashes(rng, numel, table.device)
        est = signs * torch.gather(table, 1, idx)          # (rows, numel)
        out = torch.median(est, dim=0).values
        return out.reshape(shape).to(dtype)
