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

The TPU kernels' VMEM block-column gate has no counterpart: a CUDA thread
walks a column of any length.

Layout: the flat buffer is the ``(n // k, k)`` row-major view plus one
zero-padded tail row; column ``c`` is chunk ``c`` of the wire format, and
wire indices are ``win * k + c``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from grace_tpu_torch.core import mean_scale
from grace_tpu_torch.ops import _build


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


# -- CUDA wrappers -----------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as void*, so ctypes never truncates them to 32 bits)."""
    lib = _build.library("chunk_topk")
    p, i64, f32, i32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                        ctypes.c_int)
    lib.grace_chunk_compress_feedback.argtypes = [
        p, p, p, p, p, i64, i64, f32, f32, i32, p]
    lib.grace_chunk_compress_feedback.restype = ctypes.c_int
    lib.grace_chunk_aggregate_dense.argtypes = [
        p, p, p, i64, i64, i64, i32, i32, p]
    lib.grace_chunk_aggregate_dense.restype = ctypes.c_int
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")


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
    if flat.device.type != "cuda":
        raise ValueError(f"no chunk_compress_feedback for {flat.device}")
    _check_compress_args(flat, residual, k)
    if not flat.is_contiguous() or (residual is not None
                                    and not residual.is_contiguous()):
        raise ValueError("chunk_compress_feedback takes contiguous buffers")
    lib = _lib()
    dev = flat.device
    vals = torch.empty(k, dtype=torch.bfloat16 if wire_bf16 else torch.float32,
                       device=dev)
    win = torch.empty(k, dtype=torch.int32, device=dev)
    new_resid = residual if residual is not None else torch.empty_like(flat)
    with torch.cuda.device(dev):
        err = lib.grace_chunk_compress_feedback(
            flat.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            new_resid.data_ptr(), vals.data_ptr(), win.data_ptr(),
            flat.numel(), k, float(beta), float(gamma), int(wire_bf16),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "chunk_compress_feedback")
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
    if vals.device.type != "cuda":
        raise ValueError(f"no chunk_aggregate_dense for {vals.device}")
    _check_aggregate_args(vals, win, k, n)
    if not vals.is_contiguous() or not win.is_contiguous():
        raise ValueError("chunk_aggregate_dense takes contiguous payloads")
    lib = _lib()
    dev = vals.device
    out = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.grace_chunk_aggregate_dense(
            vals.data_ptr(), win.data_ptr(), out.data_ptr(), vals.shape[0], k,
            n, int(vals.dtype == torch.bfloat16), int(average),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "chunk_aggregate_dense")
    chunk_aggregate_dense.launches += 1
    return out


chunk_aggregate_dense.launches = 0


def reset_launch_counts() -> None:
    chunk_compress_feedback.launches = 0
    chunk_aggregate_dense.launches = 0
