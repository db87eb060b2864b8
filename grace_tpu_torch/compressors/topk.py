"""Top-K magnitude sparsification, exact and chunked.

Counterpart of the JAX package's ``compressors/topk.py``: keep k =
max(1, int(ratio·n)) entries, ship ``(values, int32 indices)``, scatter
into zeros to decompress. ``'chunk'`` keeps the largest-|x| entry of each
strided chunk (column ``c`` of the ``(rows, k)`` view), so indices are
``win_row*k + c``.

``'approx'`` is ``lax.approx_max_k`` in the JAX package where the flat
tensor holds more than ``4k`` entries, and the exact selection elsewhere.
Off the TPU, XLA lowers ``approx_max_k`` to an exact sort, whatever the
``recall_target``; so the port selects exactly (``torch.topk``), which is
what the JAX package computes on the CPU, and keeps ``recall_target`` for
the params dicts.

``use_pallas`` keeps its JAX name so the JAX params dicts build unchanged.
Its meaning in the port: ``False`` (or the ``topk`` family turned off by
the environment: ``ops.pallas_mode``) selects the staged tensor path;
``True`` and ``'auto'`` select the fused chunk kernels, which launch the
CUDA kernel for CUDA tensors and run the kernel's plain version for CPU
tensors. (In the JAX package ``'auto'`` means staged, a choice measured on
a TPU that says nothing about this card.)
"""

from __future__ import annotations

import dataclasses

import torch

from grace_tpu_torch.core import Compressor, Ctx, LeafKey, Payload, State
from grace_tpu_torch.ops import chunk_topk, pallas_mode
from grace_tpu_torch.ops.sparse import chunkwise_dense, scatter_dense


def static_k(numel: int, ratio: float) -> int:
    return max(1, int(numel * ratio))


@dataclasses.dataclass(frozen=True)
class TopKCompressor(Compressor):
    # Re-selecting top-k over a partial sum is a sound multi-hop relaxation.
    supports_hop_requant = True
    # Per-rank index sets: payloads of different ranks do not sum.
    payload_algebra = None

    compress_ratio: float = 0.3
    algorithm: str = "exact"      # 'exact' | 'approx' | 'chunk'
    recall_target: float = 0.95   # 'approx' only; selection is exact here
    wire_dtype: str = "float32"   # 'float32' | 'bfloat16' wire values
    use_pallas: bool | str = "auto"

    def __post_init__(self):
        if self.algorithm not in ("exact", "approx", "chunk"):
            raise ValueError(f"unknown topk algorithm {self.algorithm!r}")
        if self.wire_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown wire_dtype {self.wire_dtype!r}")
        if not (self.use_pallas == "auto" or self.use_pallas is True
                or self.use_pallas is False):
            raise ValueError(f"use_pallas must be True, False or 'auto'; "
                             f"got {self.use_pallas!r}")

    def _kernel_path(self) -> bool:
        """The chunk algorithm with the ``topk`` kernel family on."""
        return (self.algorithm == "chunk"
                and pallas_mode(self.use_pallas, "topk"))

    def _chunk_k(self, numel: int, dtype) -> int | None:
        """k where a leaf passes the kernels' semantic gates (they compute
        and ship float32 and need at least two rows), else None."""
        if dtype != torch.float32:
            return None
        k = static_k(numel, self.compress_ratio)
        return k if numel >= 2 * k else None

    def _fused_k(self, numel: int, dtype) -> int | None:
        """k when the fused chunk kernels apply, else None (staged path)."""
        if not self._kernel_path():
            return None
        return self._chunk_k(numel, dtype)

    def fused_feedback_compress(self, x: torch.Tensor, state, coeffs,
                                rng: LeafKey):
        """The ``Communicator.step`` fast path: compensate, compress and
        residual update in one kernel. ``coeffs = (beta, gamma)`` is the
        memory's ``compensate = beta*state + gamma*x``. Returns
        ``(payload, ctx, new_state)``, bit-identical to the staged stages,
        or None where the staged path must run."""
        k = self._fused_k(x.numel(), x.dtype)
        if k is None or (state is not None and state.dtype != torch.float32):
            return None
        beta, gamma = coeffs
        resid = None if state is None else state.reshape(-1)
        values, win_row, new_resid = chunk_topk.chunk_compress_feedback(
            x.reshape(-1), resid, k, beta=float(beta), gamma=float(gamma),
            wire_bf16=self.wire_dtype == "bfloat16")
        indices = torch.arange(k, dtype=torch.int32, device=x.device)
        indices.add_(win_row, alpha=k)             # win_row*k + c, in place
        new_state = None if state is None else new_resid.reshape(state.shape)
        return (values, indices), (x.numel(), tuple(x.shape), x.dtype), \
            new_state

    def fused_feedback_compress_leaves(self, xs, states, coeffs, rngs):
        """The grouped fast path of ``Communicator.step_leaves``: every leaf
        that passes :meth:`fused_feedback_compress`'s gates (float32,
        ``n >= 2k``, a float32 residual; both contiguous, since the kernel
        reads them in place) goes through ONE grouped kernel
        launch. Returns ``(taken, payload, ctx, new_states)``: the indices
        of the leaves taken, their payloads concatenated in leaf order
        (``(values[K], indices[K])``, wire indices ``win_row*k + c``), the
        decode ctx of the group and their new residuals; or None where no
        leaf passes or the kernel path is off. Per leaf, bit-identical to
        the one-leaf path."""
        if not self._kernel_path():            # one switch read a step
            return None
        taken, ks = [], []
        for i, (x, state) in enumerate(zip(xs, states)):
            k = self._chunk_k(x.numel(), x.dtype)
            if (k is not None and state is not None
                    and state.dtype == torch.float32 and x.is_contiguous()
                    and state.is_contiguous()):
                taken.append(i)
                ks.append(k)
        if not taken:
            return None
        beta, gamma = coeffs
        # The kernel selects over each leaf's flat order, whatever its shape:
        # no per-leaf reshape (a view costs microseconds of host time).
        grads = [xs[i] for i in taken]
        values, indices, new_states = \
            chunk_topk.chunk_compress_feedback_grouped(
                grads, [states[i] for i in taken], ks, beta=float(beta),
                gamma=float(gamma), wire_bf16=self.wire_dtype == "bfloat16")
        ctx = (tuple(ks), tuple(g.numel() for g in grads),
               tuple(g.shape for g in grads))
        return taken, (values, indices), ctx, new_states

    def fused_roundtrip_leaves(self, xs):
        """The telemetry's compress → decompress round-trip of every leaf
        the chunk kernels take, in ONE grouped compress launch without
        feedback: its new residual is ``x − decompress(compress(x))``
        exactly (``gamma = 1`` leaves ``x`` as it is, and the residual is
        ``x`` with the kept lanes, wire-rounded, taken out). Returns
        ``(taken, errors)`` or None where no leaf passes or the kernel
        path is off."""
        if not self._kernel_path():
            return None
        taken, ks = [], []
        for i, x in enumerate(xs):
            k = self._chunk_k(x.numel(), x.dtype)
            if k is not None and x.is_contiguous():
                taken.append(i)
                ks.append(k)
        if not taken:
            return None
        _, _, errors = chunk_topk.chunk_compress_feedback_grouped(
            [xs[i] for i in taken], [None] * len(taken), ks,
            wire_bf16=self.wire_dtype == "bfloat16")
        return taken, errors

    def fused_aggregate_decompress_leaves(self, gathered: Payload, ctx,
                                          world: int):
        """The grouped aggregate of the leaves of
        :meth:`fused_feedback_compress_leaves`: ``(world, K)`` gathered
        payloads → each leaf's aggregated (÷world with ``average``) dense
        tensor, in one kernel launch. The leaves' outputs are views of one
        buffer."""
        ks, ns, shapes = ctx
        values, indices = gathered
        out = chunk_topk.chunk_aggregate_dense_grouped(
            values, indices, ks, ns, average=self.average)
        return [o if len(shape) == 1 else o.view(shape)
                for o, shape in zip(out.split(ns), shapes)]

    def _chunk_compress(self, flat: torch.Tensor, k: int):
        """Staged chunk selection: argmax of |x| over each column of the
        zero-padded ``(rows, k)`` view (first max wins, so padding lanes
        never win over a real row), values by masked sum."""
        n = flat.numel()
        rows = -(-n // k)
        body = torch.zeros(rows * k, dtype=flat.dtype, device=flat.device)
        body[:n] = flat
        body = body.reshape(rows, k)
        win_row = torch.argmax(body.abs(), dim=0).to(torch.int32)
        row_ids = torch.arange(rows, dtype=torch.int32, device=flat.device)
        mask = row_ids[:, None] == win_row[None, :]
        zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
        values = torch.sum(torch.where(mask, body, zero), dim=0)
        indices = win_row * k + torch.arange(k, dtype=torch.int32,
                                             device=flat.device)
        return values, indices

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        shape, numel = tuple(x.shape), x.numel()
        flat = x.reshape(-1)
        k = static_k(numel, self.compress_ratio)
        if self.algorithm == "chunk" and numel >= 2 * k:
            values, indices = self._chunk_compress(flat, k)
        else:
            # Exact top-k ('approx' included: see the module docstring).
            # Its tie order differs from lax.top_k; the wire set is the
            # same wherever magnitudes are distinct.
            indices = torch.topk(flat.abs(), k).indices.to(torch.int32)
            values = flat[indices.long()]
        if self.wire_dtype == "bfloat16":
            # The rounding error lands in the residual memory.
            values = values.to(torch.bfloat16)
        return (values, indices), (numel, shape, x.dtype), state

    def fused_aggregate_decompress(self, gathered: Payload, ctx: Ctx,
                                   world: int):
        """Allgather fast path: ``(world, k)`` payload stacks → the
        aggregated (÷world with ``average``) dense tensor in one kernel.
        None = staged path."""
        numel, shape, dtype = ctx
        k = self._fused_k(numel, dtype)
        if k is None:
            return None
        values, indices = gathered
        if tuple(values.shape) != (world, k):
            return None                  # sub-k payloads lose chunk structure
        win = torch.div(indices, k, rounding_mode="floor").to(torch.int32)
        out = chunk_topk.chunk_aggregate_dense(values, win, k, numel,
                                               average=self.average)
        return out.reshape(shape).to(dtype)

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        values, indices = payload
        numel, shape, dtype = ctx
        k = static_k(numel, self.compress_ratio)
        if (self.algorithm == "chunk" and numel >= 2 * k
                and values.shape[0] == k):
            rows = -(-numel // k)
            win_row = torch.div(indices, k, rounding_mode="floor").to(
                torch.int32)
            return chunkwise_dense(values.to(dtype), win_row, rows, numel,
                                   shape)
        return scatter_dense(values.to(dtype), indices, numel, shape)
