"""Deep Gradient Compression's sampled-threshold Top-K; counterpart of the
JAX package's ``compressors/dgc.py``.

A 1% sample of |x| (indices drawn with replacement from the leaf's key,
``LeafKey.randint``) estimates the Top-K threshold; up to
``max_refinements`` rounds scale it by 1.3 or 0.7 until the count of
entries at or above it lies in ``[0.7k, 1.3k]``. The payload has a fixed
capacity of ``int(1.3k) + 1`` lanes, the largest-|x| entries, and lanes
under the threshold carry 0. Pair it with ``memories.DgcMemory``.

The JAX package spells the refinement as a ``lax.while_loop`` that stops
at the first count in the band. Here it is ``max_refinements`` masked
rounds on the device (:func:`refine_threshold`): a round after the band
was reached changes nothing, so the threshold is the same bit for bit,
and no round reads a count back to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from grace_tpu_torch.core import Compressor, Ctx, LeafKey, Payload, State
from grace_tpu_torch.ops.sparse import scatter_dense


def refine_threshold(thr: torch.Tensor, count, steps: int, too_many,
                     too_few, up: float, down: float):
    """The threshold refinement loop, masked: ``steps`` rounds of ``thr =
    up·thr`` where ``too_many(sel)``, ``down·thr`` where ``too_few(sel)``,
    each followed by ``sel = count(thr)``, stopping (in effect) at the
    first round whose count is neither. ``up``/``down`` multiply in
    float32, as JAX's weak-typed Python floats do. Returns ``(thr,
    sel)``."""
    sel = count(thr)
    active = torch.ones((), dtype=torch.bool, device=thr.device)
    for _ in range(steps):
        many, few = too_many(sel), too_few(sel)
        active = active & (many | few)
        stepped = torch.where(many, thr * up, torch.where(few, thr * down,
                                                          thr))
        thr = torch.where(active, stepped, thr)
        sel = torch.where(active, count(thr), sel)
    return thr, sel


def f32(v: float) -> float:
    """``v`` rounded to float32: a JAX weak-typed Python float in a
    float32 comparison."""
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class DgcCompressor(Compressor):
    tensors_size_are_same = False
    # Capacity-masked (values, per-rank indices): no algebra, no requant.
    payload_algebra = None
    supports_hop_requant = False

    compress_ratio: float = 0.01
    sample_ratio: float = 0.01
    max_refinements: int = 10

    def threshold(self, abs_flat: torch.Tensor, rng: LeafKey
                  ) -> torch.Tensor:
        """The refined threshold of one leaf's |x|."""
        numel = abs_flat.numel()
        num_samples = max(1, int(numel * self.sample_ratio))
        sample_idx = rng.randint((num_samples,), 0, numel, abs_flat.device)
        sample = abs_flat[sample_idx.long()]
        k_sample = max(1, int(numel * self.compress_ratio
                              * self.sample_ratio))
        thr0 = torch.topk(sample, k_sample).values[-1]
        target = numel * self.compress_ratio
        hi, lo = f32(1.3 * target), f32(0.7 * target)

        def count(thr):
            return torch.sum(abs_flat >= thr).to(torch.float32)

        thr, _ = refine_threshold(thr0, count, self.max_refinements,
                                  lambda s: s > hi, lambda s: s < lo,
                                  1.3, 0.7)
        return thr

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        shape, numel = tuple(x.shape), x.numel()
        flat = x.reshape(-1)
        abs_flat = flat.abs()
        thr = self.threshold(abs_flat, rng)
        cap = min(numel, max(1, int(numel * self.compress_ratio * 1.3) + 1))
        mags, indices = torch.topk(abs_flat, cap)
        values = torch.where(mags >= thr, flat[indices],
                             torch.zeros((), dtype=flat.dtype,
                                         device=flat.device))
        return (values, indices.to(torch.int32)), (numel, shape), state

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        values, indices = payload
        numel, shape = ctx
        return scatter_dense(values, indices, numel, shape)
