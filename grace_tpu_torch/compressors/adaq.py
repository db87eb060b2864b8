"""AdaQ: adaptive two-sided quantisation (Dryden et al. 2016); counterpart
of the JAX package's ``compressors/adaq.py``.

The positive and the negative entries each run a DGC-style sampled
threshold (up to ``max_refinements`` rounds, accepting ``[0.8t, 1.25t]``
for ``t = ceil(count·ratio)``, scaling by 1.25 or 0.9, then 0.8 once more
if nothing is selected), under the two halves of the leaf's key
(``LeafKey.split``). Each side sends its selected entries' mean, a fixed
capacity of the largest-|x| indices, and a validity bit per index packed
8 to a byte; every valid index decodes to its side's mean. The refinement
runs as masked rounds on the device, as in ``dgc.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from grace_tpu_torch.compressors.dgc import refine_threshold
from grace_tpu_torch.core import Compressor, Ctx, LeafKey, Payload, State
from grace_tpu_torch.ops.packing import pack_bits, unpack_bits


@dataclasses.dataclass(frozen=True)
class AdaqCompressor(Compressor):
    tensors_size_are_same = False
    # Per-rank means over per-rank selections: no algebra.
    payload_algebra = None
    supports_hop_requant = False

    compress_ratio: float = 0.01
    sample_ratio: float = 0.01
    max_refinements: int = 20

    def capacity(self, numel: int) -> int:
        return max(1, min(numel, int(numel * 0.5 * self.compress_ratio * 2)
                          + 1))

    def _half(self, masked: torch.Tensor, count: torch.Tensor, numel: int,
              rng: LeafKey):
        abs_masked = masked.abs()
        num_samples = max(1, int(numel * self.sample_ratio))
        sample_idx = rng.randint((num_samples,), 0, numel, masked.device)
        sample = abs_masked[sample_idx.long()]
        k_sample = max(1, int(numel * 0.5 * self.sample_ratio
                              * self.compress_ratio))
        thr0 = torch.topk(sample, k_sample).values[-1]
        target = torch.ceil(count.to(torch.float32) * self.compress_ratio)
        hi, lo = target * 1.25, target * 0.8

        def count_sel(thr):
            return torch.sum(abs_masked > thr).to(torch.float32)

        thr, sel = refine_threshold(thr0, count_sel, self.max_refinements,
                                    lambda s: s > hi, lambda s: s < lo,
                                    1.25, 0.9)
        thr = torch.where(sel < 1, thr * 0.8, thr)
        sel_mask = abs_masked > thr
        zero = torch.zeros((), dtype=masked.dtype, device=masked.device)
        mean = torch.sum(torch.where(sel_mask, masked, zero)) \
            / torch.clamp_min(torch.sum(sel_mask), 1).to(masked.dtype)
        mags, indices = torch.topk(abs_masked, self.capacity(numel))
        return mean, indices.to(torch.int32), pack_bits(mags > thr)

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        flat = x.reshape(-1)
        numel = flat.numel()
        rng_p, rng_m = rng.split()
        zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
        plus = torch.where(flat > 0, flat, zero)
        minus = torch.where(flat < 0, flat, zero)
        p = self._half(plus, torch.sum(flat > 0), numel, rng_p)
        m = self._half(minus, torch.sum(flat < 0), numel, rng_m)
        return (*p, *m), (numel, tuple(x.shape), x.dtype), state

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        p_mean, p_idx, p_valid, m_mean, m_idx, m_valid = payload
        numel, shape, dtype = ctx
        cap = p_idx.shape[0]
        zero = torch.zeros((), dtype=p_mean.dtype, device=p_mean.device)
        out = torch.zeros(numel, dtype=dtype, device=p_mean.device)
        pv = torch.where(unpack_bits(p_valid, cap), p_mean, zero).to(dtype)
        mv = torch.where(unpack_bits(m_valid, cap), m_mean, zero).to(dtype)
        out.index_add_(0, p_idx.long(), pv)
        out.index_add_(0, m_idx.long(), mv)
        return out.reshape(shape)
