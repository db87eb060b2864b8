"""Chunk Top-K kernels: fused error-feedback compress, and the W-way aggregate.

Counterpart of the JAX package's ``ops/pallas_topk.py``. Each function
comes three ways:

* ``*_plain`` — the plain PyTorch version, written op for op after the
  Pallas kernel body. It is the kernel's oracle, and what runs for tensors
  on the CPU.
* the wrapper (``chunk_compress_feedback`` / ``chunk_aggregate_dense``) —
  for CUDA tensors it launches the hand-written kernel of
  ``grace_tpu_torch/csrc/chunk_topk.cu`` on the current stream, or raises;
  for CPU tensors it runs the plain version. Nothing else chooses.
* a launch counter, ``<wrapper>.launches``: a plain integer the wrapper
  adds one to where it launches its kernel, and nowhere else, so a run can
  show that its main path went through the kernel.

Each kernel also has a grouped wrapper over many leaves
(``chunk_compress_feedback_grouped`` / ``chunk_aggregate_dense_grouped``,
with their own ``*_plain`` versions and counters): one launch covers up to
``MAX_LEAVES_PER_LAUNCH`` leaves, their payloads concatenated in leaf order
(K-space) with wire indices ``win * k + c``. The one-leaf wrappers are the
one-leaf case of the same kernels. A grouped launch is described by a
:class:`LeafPlan`, which depends only on the leaves' sizes and is cached.

The TPU kernels' VMEM block-column gate has no counterpart: the CUDA
kernels walk columns of any length, and the aggregate walks any number of
ranks (in tiles of ranks that its shared memory stages).

Layout: the flat buffer is the ``(n // k, k)`` row-major view plus one
zero-padded tail row; column ``c`` is chunk ``c`` of the wire format, and
wire indices are ``win * k + c``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import operator
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from grace_tpu_torch.core import mean_scale
from grace_tpu_torch.ops import _build
from grace_tpu_torch.ops import fake as _fake

# The kernels' tile width and leaf table capacity (csrc/chunk_topk.cu
# kTileCols and kMaxLeaves).
TILE_COLS = 32
MAX_LEAVES_PER_LAUNCH = 256


def _views(buf: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(main rows view, zero-padded tail row) of a flat buffer."""
    n = buf.numel()
    main_rows = n // k
    rem = n - main_rows * k
    main = buf[:main_rows * k].reshape(main_rows, k)
    tail = torch.zeros((1, k), dtype=buf.dtype, device=buf.device)
    if rem:
        tail[0, :rem] = buf[main_rows * k:]
    return main, tail


def _check_compress_args(flat, residual, k):
    n = flat.numel()
    if k < 1 or n < 2 * k:
        raise ValueError(f"chunk_compress_feedback needs n >= 2k >= 2; got "
                         f"n={n}, k={k}")
    if flat.dtype != torch.float32 or flat.dim() != 1:
        raise ValueError("chunk_compress_feedback takes a flat float32 "
                         f"gradient; got {flat.dtype} of shape "
                         f"{tuple(flat.shape)}")
    if residual is not None and (residual.dtype != torch.float32
                                 or residual.shape != flat.shape
                                 or residual.device != flat.device):
        raise ValueError("the residual must match the gradient: float32, "
                         f"shape {tuple(flat.shape)}, on {flat.device}")


def chunk_compress_feedback_plain(flat: torch.Tensor,
                                  residual: Optional[torch.Tensor], k: int,
                                  beta: float = 1.0, gamma: float = 1.0,
                                  wire_bf16: bool = False):
    """``comp = gamma*flat + beta*residual`` → per-column first-max select
    → ``(vals, win, new_residual)``; the plain version of the kernel.

    ``residual=None`` drops the feedback term; ``new_residual`` is then the
    keep-complement of ``gamma*flat``.
    """
    _check_compress_args(flat, residual, k)
    n = flat.numel()
    main_rows = n // k
    rem = n - main_rows * k
    g_main, g_tail = _views(flat, k)
    comp = g_main * gamma
    tcomp = g_tail * gamma
    if residual is not None:
        r_main, r_tail = _views(residual, k)
        comp = comp + r_main * beta
        tcomp = tcomp + r_tail * beta
    a = comp.abs()
    at = tcomp.abs()
    m = torch.maximum(torch.amax(a, dim=0, keepdim=True), at)  # NaN sticks
    row_iota = torch.arange(main_rows, dtype=torch.int32,
                            device=flat.device)[:, None].expand(main_rows, k)
    sentinel = torch.full_like(row_iota, main_rows)
    # First main row reaching the max; sentinel main_rows if none does.
    win_main = torch.amin(torch.where(a == m, row_iota, sentinel), dim=0,
                          keepdim=True)
    tail_hit = at == m
    # Winner: first main-row max, else the tail row, else (a NaN column,
    # where no equality fires) row 0.
    win = torch.where(win_main < main_rows, win_main,
                      torch.where(tail_hit, main_rows, 0).to(torch.int32))
    hot = row_iota == win
    hot_tail = win == main_rows
    zero = torch.zeros((), dtype=comp.dtype, device=comp.device)
    vals = (torch.sum(torch.where(hot, comp, zero), dim=0, keepdim=True)
            + torch.where(hot_tail, tcomp, zero))
    if wire_bf16:
        vals = vals.to(torch.bfloat16)
        dense = vals.to(comp.dtype)      # the residual absorbs the rounding
    else:
        dense = vals
    resid_main = comp - torch.where(hot, dense, zero)
    resid_tail = tcomp - torch.where(hot_tail, dense, zero)
    new_resid = torch.cat([resid_main.reshape(-1), resid_tail[0, :rem]])
    return vals.reshape(k), win.reshape(k), new_resid


def chunk_aggregate_dense_plain(vals: torch.Tensor, win: torch.Tensor, k: int,
                                n: int, average: bool = True) -> torch.Tensor:
    """``(world, k)`` gathered payloads → one dense float32 tensor: each
    rank's one-hot row select, summed in rank order, scaled by
    :func:`~grace_tpu_torch.core.mean_scale` when ``average``; the plain
    version of the kernel."""
    _check_aggregate_args(vals, win, k, n)
    main_rows = n // k
    rem = n - main_rows * k
    world = vals.shape[0]
    v = vals.to(torch.float32)
    row_iota = torch.arange(main_rows, dtype=torch.int32,
                            device=vals.device)[:, None]
    acc = torch.zeros((main_rows, k), dtype=torch.float32, device=vals.device)
    tail = torch.zeros((1, k), dtype=torch.float32, device=vals.device)
    zero = torch.zeros((), dtype=torch.float32, device=vals.device)
    for i in range(world):
        vi, wi = v[i][None, :], win[i][None, :]
        acc = acc + torch.where(row_iota == wi, vi, zero)
        tail = tail + torch.where(wi == main_rows, vi, zero)
    if average:                           # acc / world, as XLA computes it
        acc = acc * mean_scale(world)
        tail = tail * mean_scale(world)
    return torch.cat([acc.reshape(-1), tail[0, :rem]])


def _check_aggregate_args(vals, win, k, n):
    if vals.dim() != 2 or vals.shape[1] != k or win.shape != vals.shape:
        raise ValueError(f"chunk_aggregate_dense takes (world, k={k}) vals "
                         f"and win; got {tuple(vals.shape)} and "
                         f"{tuple(win.shape)}")
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"vals must be float32 or bfloat16; got {vals.dtype}")
    if win.dtype != torch.int32 or win.device != vals.device:
        raise ValueError("win must be int32 on the device of vals")
    if k < 1 or n < k:
        raise ValueError(f"chunk_aggregate_dense needs n >= k >= 1; got "
                         f"n={n}, k={k}")


# -- the grouped functions: many leaves, one concatenated payload -------------

@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Where each leaf of a grouped launch lives, from its size alone.

    ``noff``/``koff``: offsets of leaf ``l`` in the concatenated dense
    buffer (N-space) and payload (K-space), with totals at index ``L``;
    ``tile0``: its first tile of ``TILE_COLS`` columns (a prefix sum of
    ``ceil(k / TILE_COLS)``); ``launches``: the ``[lo, hi)`` leaf spans of
    the kernel launches, at most ``MAX_LEAVES_PER_LAUNCH`` leaves each.
    """

    ns: Tuple[int, ...]
    ks: Tuple[int, ...]
    noff: np.ndarray
    koff: np.ndarray
    tile0: np.ndarray
    launches: Tuple[Tuple[int, int], ...]
    _tables: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    @property
    def n_total(self) -> int:
        return int(self.noff[-1])

    @property
    def k_total(self) -> int:
        return int(self.koff[-1])

    def table(self, lo: int, hi: int, pointers: int) -> np.ndarray:
        """A fresh copy of the kernel's leaf table for the launch over
        leaves ``[lo, hi)``: ``pointers`` zeroed pointer words a row, then
        n, k, koff and the first tile counted from the launch's first
        leaf. The template is built once per plan."""
        key = (lo, hi, pointers)
        if key not in self._tables:
            rows = np.zeros((hi - lo, pointers + 4), dtype=np.int64)
            rows[:, pointers] = self.ns[lo:hi]
            rows[:, pointers + 1] = self.ks[lo:hi]
            rows[:, pointers + 2] = self.koff[lo:hi]
            rows[:, pointers + 3] = self.tile0[lo:hi] - self.tile0[lo]
            self._tables[key] = rows
        return self._tables[key].copy()


@functools.lru_cache(maxsize=64)
def leaf_plan(ks: Tuple[int, ...], ns: Tuple[int, ...]) -> LeafPlan:
    """The cached :class:`LeafPlan` of leaves of sizes ``ns`` keeping
    ``ks`` elements each."""
    if len(ks) != len(ns) or not ks:
        raise ValueError(f"a leaf plan needs one k per leaf; got {len(ks)} "
                         f"ks for {len(ns)} leaves")
    if any(k < 1 or n < k for k, n in zip(ks, ns)):
        raise ValueError("every leaf needs n >= k >= 1")

    def prefix(xs):
        return np.concatenate([[0], np.cumsum(xs, dtype=np.int64)])

    tiles = [-(-k // TILE_COLS) for k in ks]
    launches = tuple((lo, min(lo + MAX_LEAVES_PER_LAUNCH, len(ks)))
                     for lo in range(0, len(ks), MAX_LEAVES_PER_LAUNCH))
    return LeafPlan(tuple(ns), tuple(ks), prefix(ns), prefix(ks),
                    prefix(tiles), launches)


def chunk_compress_feedback_grouped_plain(
        grads: Sequence[torch.Tensor],
        residuals: Sequence[Optional[torch.Tensor]], ks: Sequence[int],
        beta: float = 1.0, gamma: float = 1.0, wire_bf16: bool = False):
    """The plain version of the grouped compress: the one-leaf plain
    version over each leaf, wire indices ``win * k + c``, concatenated.
    Returns ``(vals[K], indices[K], new_residuals)``."""
    vals, idx, resids = [], [], []
    for g, r, k in zip(grads, residuals, ks):
        v, win, nr = chunk_compress_feedback_plain(g, r, k, beta, gamma,
                                                   wire_bf16)
        vals.append(v)
        idx.append(win * k + torch.arange(k, dtype=torch.int32,
                                          device=g.device))
        resids.append(nr)
    return torch.cat(vals), torch.cat(idx), resids


def chunk_aggregate_dense_grouped_plain(vals: torch.Tensor,
                                        indices: torch.Tensor,
                                        ks: Sequence[int], ns: Sequence[int],
                                        average: bool = True) -> torch.Tensor:
    """The plain version of the grouped aggregate: ``(W, K)`` gathered
    payloads of the leaves in K-space → the leaves' dense outputs
    concatenated (N-space). Each leaf's rows are its indices floor-divided
    by its k; the one-leaf plain version does the rest."""
    plan = leaf_plan(tuple(ks), tuple(ns))
    _check_grouped_aggregate_args(vals, indices, plan)
    outs = []
    for l, (k, n) in enumerate(zip(plan.ks, plan.ns)):
        lo = int(plan.koff[l])
        win = torch.div(indices[:, lo:lo + k], k,
                        rounding_mode="floor").to(torch.int32)
        outs.append(chunk_aggregate_dense_plain(vals[:, lo:lo + k], win, k,
                                                n, average))
    return torch.cat(outs)


def _check_grouped_aggregate_args(vals, indices, plan: LeafPlan):
    if (vals.dim() != 2 or vals.shape[1] != plan.k_total
            or indices.shape != vals.shape):
        raise ValueError(f"chunk_aggregate_dense_grouped takes (world, "
                         f"K={plan.k_total}) vals and indices; got "
                         f"{tuple(vals.shape)} and {tuple(indices.shape)}")
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"vals must be float32 or bfloat16; got {vals.dtype}")
    if indices.dtype != torch.int32 or indices.device != vals.device:
        raise ValueError("indices must be int32 on the device of vals")


# -- CUDA wrappers -----------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as void*, so ctypes never truncates them to 32 bits)."""
    lib = _build.library("chunk_topk")
    p, i64, f32, i32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                        ctypes.c_int)
    lib.grace_chunk_compress_feedback.argtypes = [
        p, i32, p, p, f32, f32, i32, i32, p]
    lib.grace_chunk_compress_feedback.restype = ctypes.c_int
    lib.grace_chunk_aggregate_dense.argtypes = [
        p, i32, p, p, i64, i64, i32, i32, i32, p]
    lib.grace_chunk_aggregate_dense.restype = ctypes.c_int
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")


def _on(dev):
    """Run on ``dev``'s current stream: a device switch only when ``dev``
    is not the current device (entering one costs microseconds a call)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _launch_compress(rows: np.ndarray, vals, idx, beta, gamma, wire_bf16,
                     wire_indices, dev) -> None:
    with _on(dev):
        err = _lib().grace_chunk_compress_feedback(
            rows.ctypes.data, rows.shape[0], vals.data_ptr(), idx.data_ptr(),
            float(beta), float(gamma), int(wire_bf16), int(wire_indices),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "chunk_compress_feedback")


def _launch_aggregate(rows: np.ndarray, vals, idx, average, wire_indices,
                      dev) -> None:
    with _on(dev):
        err = _lib().grace_chunk_aggregate_dense(
            rows.ctypes.data, rows.shape[0], vals.data_ptr(), idx.data_ptr(),
            vals.shape[0], vals.shape[1], int(vals.dtype == torch.bfloat16),
            int(wire_indices), int(average),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "chunk_aggregate_dense")


_dtype = operator.attrgetter("dtype")


def _fake_compress(grads, residuals, ks, wire_bf16, grouped=False):
    """A fake compress launch's ``(result, written)``: the payload of
    ``sum(ks)`` values and indices, and the new residuals (each residual
    itself, written in place; a fresh buffer where it is None)."""
    if not grouped:
        grads, residuals = [grads], [residuals]
    dev = grads[0].device
    vals = torch.empty(sum(ks), dtype=torch.bfloat16 if wire_bf16
                       else torch.float32, device=dev)
    idx = torch.empty(sum(ks), dtype=torch.int32, device=dev)
    new = [torch.empty_like(g) if r is None else r
           for g, r in zip(grads, residuals)]
    return (vals, idx, new if grouped else new[0]), [vals, idx] + new


def _fresh_out(n: int, device):
    """A fake launch's ``(result, written)``: one float32 output of ``n``
    elements."""
    out = torch.empty(n, dtype=torch.float32, device=device)
    return out, (out,)


def _check_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no {name} for {t.device}")


def chunk_compress_feedback(flat: torch.Tensor,
                            residual: Optional[torch.Tensor], k: int,
                            beta: float = 1.0, gamma: float = 1.0,
                            wire_bf16: bool = False):
    """Fused compensate → chunk select → wire values → residual update.

    Returns ``(vals, win, new_residual)``: ``vals`` float32 (bfloat16 with
    ``wire_bf16``) of length ``k``, ``win`` the int32 winning row of each
    column, ``new_residual`` float32 like ``flat``. Bit-identical to
    :func:`chunk_compress_feedback_plain`.

    On CUDA the new residual is written over ``residual`` IN PLACE (the
    returned tensor is ``residual`` itself): the residual is the largest
    per-step state, and the old one is dead once the kernel has read it.
    With ``residual=None`` a fresh buffer is returned.
    """
    if flat.device.type == "cpu":
        return chunk_compress_feedback_plain(flat, residual, k, beta, gamma,
                                             wire_bf16)
    _check_cuda(flat, "chunk_compress_feedback")
    _check_compress_args(flat, residual, k)
    if not flat.is_contiguous() or (residual is not None
                                    and not residual.is_contiguous()):
        raise ValueError("chunk_compress_feedback takes contiguous buffers")
    dev = flat.device
    if _fake.is_fake(flat):
        return _fake.launch(
            "chunk_compress_feedback", [flat, residual],
            lambda: _fake_compress(flat, residual, [k], wire_bf16))
    vals = torch.empty(k, dtype=torch.bfloat16 if wire_bf16 else torch.float32,
                       device=dev)
    win = torch.empty(k, dtype=torch.int32, device=dev)
    new_resid = residual if residual is not None else torch.empty_like(flat)
    rows = np.array([[flat.data_ptr(),
                      residual.data_ptr() if residual is not None else 0,
                      new_resid.data_ptr(), flat.numel(), k, 0, 0]],
                    dtype=np.int64)
    _launch_compress(rows, vals, win, beta, gamma, wire_bf16, False, dev)
    chunk_compress_feedback.launches += 1
    return vals, win, new_resid


chunk_compress_feedback.launches = 0


def chunk_aggregate_dense(vals: torch.Tensor, win: torch.Tensor, k: int,
                          n: int, average: bool = True) -> torch.Tensor:
    """W gathered chunk payloads → the dense float32 sum (÷W with
    ``average``), one pass over the output. ``vals``: (W, k) float32 or
    bfloat16 (widened to float32 before the sum); ``win``: (W, k) int32
    winning rows. Bit-identical to :func:`chunk_aggregate_dense_plain`."""
    if vals.device.type == "cpu":
        return chunk_aggregate_dense_plain(vals, win, k, n, average)
    _check_cuda(vals, "chunk_aggregate_dense")
    _check_aggregate_args(vals, win, k, n)
    if not vals.is_contiguous() or not win.is_contiguous():
        raise ValueError("chunk_aggregate_dense takes contiguous payloads")
    if _fake.is_fake(vals):
        return _fake.launch("chunk_aggregate_dense", [vals, win],
                            lambda: _fresh_out(n, vals.device))
    out = torch.empty(n, dtype=torch.float32, device=vals.device)
    rows = np.array([[out.data_ptr(), n, k, 0, 0]], dtype=np.int64)
    _launch_aggregate(rows, vals, win, average, False, vals.device)
    chunk_aggregate_dense.launches += 1
    return out


chunk_aggregate_dense.launches = 0


def chunk_compress_feedback_grouped(
        grads: Sequence[torch.Tensor],
        residuals: Sequence[Optional[torch.Tensor]], ks: Sequence[int],
        beta: float = 1.0, gamma: float = 1.0, wire_bf16: bool = False):
    """:func:`chunk_compress_feedback` over many leaves in one launch (one
    per ``MAX_LEAVES_PER_LAUNCH`` leaves).

    ``grads``: contiguous float32 leaves (any shape; their flat order is
    selected over); ``residuals``: a float32 residual like each, or None
    for no feedback term; ``ks``: the kept elements of each. Returns
    ``(vals[K], indices[K], new_residuals)``: the leaves' payloads
    concatenated in leaf order, indices the wire indices ``win * k + c``.
    Bit-identical to :func:`chunk_compress_feedback_grouped_plain`.

    ``new_residuals[l]`` has the shape of ``residuals[l]`` (of ``grads[l]``
    where that is None). On CUDA every new residual is written over its
    residual IN PLACE, as the one-leaf wrapper does: ``new_residuals[l]`` is
    ``residuals[l]`` itself (a fresh buffer where it is None). Clone the
    residuals first to keep the old ones.
    """
    if grads[0].device.type == "cpu":
        vals, idx, resids = chunk_compress_feedback_grouped_plain(
            [g.reshape(-1) for g in grads],
            [None if r is None else r.reshape(-1) for r in residuals], ks,
            beta, gamma, wire_bf16)
        return vals, idx, [nr.view((g if r is None else r).shape)
                           for nr, g, r in zip(resids, grads, residuals)]
    _check_cuda(grads[0], "chunk_compress_feedback_grouped")
    dev = grads[0].device
    # The checks the kernel relies on (the C side checks n >= 2k) and the
    # table's pointers, read with map(): ~10 attribute reads a leaf are most
    # of this call's host time, and a Python loop over them costs more.
    ns = list(map(torch.Tensor.numel, grads))
    plan = leaf_plan(tuple(ks), tuple(ns))
    given = [r for r in residuals if r is not None]
    tensors = list(grads) + given
    dtypes = set(map(_dtype, tensors))
    devices = set(map(torch.Tensor.get_device, tensors))
    contiguous = all(map(torch.Tensor.is_contiguous, tensors))
    sizes = list(map(torch.Tensor.numel, given)) == [
        n for n, r in zip(ns, residuals) if r is not None]
    if (dtypes != {torch.float32} or devices != {dev.index} or not contiguous
            or not sizes):
        raise ValueError(
            "chunk_compress_feedback_grouped takes contiguous float32 "
            f"leaves and residuals of their sizes on {dev}; got dtypes "
            f"{sorted(map(str, dtypes))}, devices {sorted(devices)}, all "
            f"contiguous {contiguous}, residual sizes matching {sizes}")
    if _fake.is_fake(grads[0]):
        return _fake.launch(
            "chunk_compress_feedback", list(grads) + given,
            lambda: _fake_compress(grads, residuals, ks, wire_bf16, True))
    new_resids = [torch.empty_like(g) if r is None else r
                  for g, r in zip(grads, residuals)]
    gptr = list(map(torch.Tensor.data_ptr, grads))
    optr = list(map(torch.Tensor.data_ptr, new_resids))
    rptr = optr if len(given) == len(grads) else [
        0 if r is None else p for r, p in zip(residuals, optr)]
    vals = torch.empty(plan.k_total,
                       dtype=torch.bfloat16 if wire_bf16 else torch.float32,
                       device=dev)
    idx = torch.empty(plan.k_total, dtype=torch.int32, device=dev)
    for lo, hi in plan.launches:
        rows = plan.table(lo, hi, 3)
        rows[:, 0] = gptr[lo:hi]
        rows[:, 1] = rptr[lo:hi]
        rows[:, 2] = optr[lo:hi]
        _launch_compress(rows, vals, idx, beta, gamma, wire_bf16, True, dev)
        chunk_compress_feedback_grouped.launches += 1
    return vals, idx, new_resids


chunk_compress_feedback_grouped.launches = 0


def chunk_aggregate_dense_grouped(vals: torch.Tensor, indices: torch.Tensor,
                                  ks: Sequence[int], ns: Sequence[int],
                                  average: bool = True) -> torch.Tensor:
    """:func:`chunk_aggregate_dense` over many leaves in one launch (one per
    ``MAX_LEAVES_PER_LAUNCH`` leaves).

    ``vals``/``indices``: ``(W, K)`` gathered payloads of leaves of sizes
    ``ns`` keeping ``ks`` elements each, concatenated in leaf order, with
    wire indices ``win * k + c``. Returns one flat float32 tensor of the
    leaves' dense outputs concatenated (N-space); slice it into views.
    Every output element is written once. Bit-identical to
    :func:`chunk_aggregate_dense_grouped_plain`.
    """
    if vals.device.type == "cpu":
        return chunk_aggregate_dense_grouped_plain(vals, indices, ks, ns,
                                                   average)
    _check_cuda(vals, "chunk_aggregate_dense_grouped")
    plan = leaf_plan(tuple(ks), tuple(ns))
    _check_grouped_aggregate_args(vals, indices, plan)
    if not vals.is_contiguous() or not indices.is_contiguous():
        raise ValueError("chunk_aggregate_dense_grouped takes contiguous "
                         "payloads")
    if _fake.is_fake(vals):
        return _fake.launch("chunk_aggregate_dense", [vals, indices],
                            lambda: _fresh_out(plan.n_total, vals.device))
    out = torch.empty(plan.n_total, dtype=torch.float32, device=vals.device)
    for lo, hi in plan.launches:
        rows = plan.table(lo, hi, 1)
        rows[:, 0] = out.data_ptr() + 4 * plan.noff[lo:hi]
        _launch_aggregate(rows, vals, indices, average, True, vals.device)
        chunk_aggregate_dense_grouped.launches += 1
    return out


chunk_aggregate_dense_grouped.launches = 0


def reset_launch_counts() -> None:
    for f in _WRAPPERS:
        f.launches = 0


def launch_counts() -> dict:
    """Launches of each kernel, by kernel name: its one-leaf and grouped
    wrappers launch the same kernel, so their counts add."""
    return {
        "chunk_compress_feedback": (chunk_compress_feedback.launches
                                    + chunk_compress_feedback_grouped.launches),
        "chunk_aggregate_dense": (chunk_aggregate_dense.launches
                                  + chunk_aggregate_dense_grouped.launches)}


_WRAPPERS = (chunk_compress_feedback, chunk_aggregate_dense,
             chunk_compress_feedback_grouped, chunk_aggregate_dense_grouped)
