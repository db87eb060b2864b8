"""SketchML's quantile sketch; counterpart of the JAX package's
``compressors/sketch.py``.

``bins + 1`` quantile edges of the tensor, each element's bin id among
the interior edges, and each bin's mean; decompress gathers the means. The
ids travel as uint8 up to 256 bins and as uint16 above (the communicators
move integer payloads as their bytes).

The quantiles are JAX's ``linear`` method written out over one
``torch.sort``: ``q·(n − 1)`` in float32, its floor and ceiling as
indices, and ``low·(1 − w) + high·w`` with ``w = q·(n − 1) − floor``,
rounded as jitted XLA rounds it (the last add fused). ``torch.quantile``
refuses more than 2^24 elements (a ResNet-50 flat buffer holds
25,557,032), and ``torch.lerp`` rounds otherwise; a bin edge one ulp
away can move ids.
"""

from __future__ import annotations

import dataclasses

import torch

from grace_tpu_torch.core import (Compressor, Ctx, LeafKey, Payload, State,
                                  mean_scale)


def quantile_linear(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(x, q)`` (method ``'linear'``) of a 1-D float32
    tensor at float32 quantiles ``q``: a position past the end reads the
    last element (JAX's gather clamps it; ``n − 1`` rounds up in float32
    past 2^24 elements), and any NaN makes every quantile NaN."""
    s = torch.sort(x).values                 # NaN sorts last
    n = torch.tensor(float(x.numel()), dtype=q.dtype, device=q.device)
    pos = q * (n - 1)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    last = x.numel() - 1
    low = torch.clamp(low, torch.zeros_like(n), n - 1).long().clamp(0, last)
    high = torch.clamp(high, torch.zeros_like(n), n - 1).long().clamp(0,
                                                                     last)
    # ``low·(1 − w) + high·w`` with XLA's contraction of the sum into a
    # fused multiply-add, ``fma(high, w, low·(1 − w))``: the exact product
    # in float64, one add, then float32.
    lo_part = (s[low] * low_w).to(torch.float64)
    hi_part = s[high].to(torch.float64) * high_w.to(torch.float64)
    out = (hi_part + lo_part).to(torch.float32)
    return torch.where(torch.isnan(s[-1]), s[-1], out)


def bin_sums(flat: torch.Tensor, ids: torch.Tensor, bins: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each bin's sum and count of ``flat`` by ``ids`` (JAX's
    ``segment_sum``), in one fixed order on every device: the ids sorted
    stably, so each bin's elements keep their index order, then a segmented
    sum over the sorted values. The counts are integers and exact. An
    atomic ``index_add_`` adds in whatever order the card schedules, and
    its sums differ from run to run."""
    order = torch.sort(ids, stable=True).indices
    lengths = torch.bincount(ids, minlength=bins)
    sums = torch.segment_reduce(flat[order], "sum", lengths=lengths,
                                unsafe=True)
    return sums, lengths.to(flat.dtype)


@dataclasses.dataclass(frozen=True)
class SketchCompressor(Compressor):
    # Ids against per-rank edges: no algebra (the mergeable sketch is
    # CountSketchCompressor).
    payload_algebra = None
    supports_hop_requant = False

    bins: int = 64

    def quantile_points(self, device) -> torch.Tensor:
        """``jnp.linspace(0, 1, bins + 1)`` as XLA computes it in float32:
        ``i`` times the float32 reciprocal of ``bins``, and 1.0 last."""
        q = torch.arange(self.bins + 1, dtype=torch.float32,
                         device=device) * mean_scale(self.bins)
        q[-1] = 1.0
        return q

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        flat = x.reshape(-1)
        edges = quantile_linear(flat, self.quantile_points(flat.device))
        ids = torch.clamp(torch.searchsorted(edges[1:-1].contiguous(), flat,
                                             right=True),
                          0, self.bins - 1)
        sums, counts = bin_sums(flat, ids, self.bins)
        means = sums / torch.clamp_min(counts, 1.0)
        if self.bins <= 256:
            ids = ids.to(torch.uint8)
        else:                  # uint16 through int16 bits: a view
            ids = ids.to(torch.int16).view(torch.uint16)
        return (ids, means), (tuple(x.shape), x.dtype), state

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        ids, means = payload
        shape, dtype = ctx
        if ids.dtype == torch.uint16:
            ids = ids.view(torch.int16).to(torch.int32) & 0xFFFF
        return means[ids.long()].reshape(shape).to(dtype)
