"""PowerSGD low-rank compression; counterpart of the JAX package's
``compressors/powersgd.py``.

The one codec that communicates inside ``compress``: ``P = M·Q``,
all-reduce and average P over the group, orthogonalise it, ``Q = Mᵀ·P``,
all-reduce and average Q. ``compress`` returns an empty payload, so the
communicator has nothing to send, and ``decompress`` rebuilds ``P·Qᵀ``.
The two all-reduces run over ``group`` (the JAX package's mesh axis).

Layout: a tensor is factored as ``(-1, shape[-1])``, its output channels
(the last axis of an HWIO kernel or a ``(din, dout)`` weight) on one side,
as in the JAX package. 1-D leaves bypass the codec: the payload is the
tensor itself, summed and averaged by the communicator.

Q is per-leaf compressor state. ``warm_start=True`` reuses last step's Q
as the power iteration's start; ``False`` draws a fresh Gaussian Q from
the leaf's key each step (``LeafKey.normal``), the same on every rank.
The initial Q is ``jax.random.normal(jax.random.key(x.size), (m, rs))``
in the JAX package; it is drawn here with ``models/threefry.py``, which
reproduces those draws within a few ulps, so both packages start from
the same Q. ``state_rank`` pads the stored Q to a wider rank (adapt
ladders); the active rank's columns lead and the tail is carried as it
is.

Orthogonalisation is ``torch.linalg.qr`` (Householder, LAPACK's sign
convention on the CPU and on the card), as ``jnp.linalg.qr`` is in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.distributed as dist

from grace_tpu_torch.core import (Compressor, Ctx, LeafKey, Payload, State,
                                  mean_scale)
from grace_tpu_torch.telemetry import counters


def _factor_shapes(shape, rank: int):
    m = shape[-1]                  # output channels
    n = math.prod(shape[:-1])
    return n, m, min(n, m, rank)


@dataclasses.dataclass(frozen=True)
class PowerSGDCompressor(Compressor):
    rank: int = 1
    warm_start: bool = True
    group: Optional[Any] = None    # torch.distributed group; None = default
    state_rank: Optional[int] = None
    # 1-D leaves ride the communicator dense; the others were averaged
    # inside compress, so every rank holds the same factors: exact.
    payload_algebra = "exact"
    supports_hop_requant = False

    def _state_cols(self, n: int, m: int) -> int:
        if self.state_rank is not None:
            if self.state_rank < self.rank:
                raise ValueError(
                    f"PowerSGD state_rank={self.state_rank} < rank="
                    f"{self.rank}: the stored Q must hold at least the "
                    "active columns")
            return min(n, m, self.state_rank)
        return min(n, m, self.rank)

    def init_state(self, x: torch.Tensor) -> State:
        if x.dim() <= 1:
            return None
        from grace_tpu_torch.models import threefry
        n, m, _ = _factor_shapes(tuple(x.shape), self.rank)
        rs = self._state_cols(n, m)
        q = threefry.normal(threefry.key(x.numel()), (m, rs))
        return torch.from_numpy(q).to(device=x.device, dtype=x.dtype)

    def wire_nbytes(self, shape, dtype) -> int:
        """Analytic: the two all-reduces of P ``(n, r)`` and Q ``(m, r)``
        are the wire traffic; the payload is empty."""
        itemsize = torch.empty((), dtype=dtype).element_size()
        shape = tuple(shape)
        if len(shape) <= 1:
            return math.prod(shape) * itemsize
        n, m, r = _factor_shapes(shape, self.rank)
        return (n + m) * r * itemsize

    def _all_reduce_mean(self, t: torch.Tensor) -> torch.Tensor:
        counters.count("all_reduce", t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t * mean_scale(dist.get_world_size(self.group))   # t / W

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        if x.dim() <= 1:
            return (x,), None, state
        shape = tuple(x.shape)
        n, m, r = _factor_shapes(shape, self.rank)
        matrix = x.reshape(n, m)
        if self.warm_start:
            q = state[:, :r]
        else:
            q = rng.normal((m, r), x.device).to(x.dtype)
        q, _ = torch.linalg.qr(q)
        p = self._all_reduce_mean(matrix @ q)
        p, _ = torch.linalg.qr(p)
        q = self._all_reduce_mean(matrix.T @ p)
        return (), (p, q, shape), torch.cat([q, state[:, r:]], dim=1)

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        if ctx is None:
            (x,) = payload
            return x
        p, q, shape = ctx
        return (p @ q.T).reshape(shape)
