"""The decode side of the wire path: K packed payloads → one float32 partial.

Counterpart of the JAX package's ``ops/pallas_wire.py``, in the pattern of
``ops/chunk_topk.py``: :func:`decode_accumulate_plain` is the plain PyTorch
version (the oracle, and what runs for CPU tensors), :func:`decode_accumulate`
launches the hand-written kernel of ``grace_tpu_torch/csrc/wire.cu`` for
CUDA tensors or raises, and ``decode_accumulate.launches`` counts its
launches.

The bit-identity contract is the JAX package's: the fused decode equals the
staged sequential ``decompress(payload_0) + decompress(payload_1) + …`` —
the same unpack layout, the same sign extension, the same per-payload scale
(pre-divided by the caller with the staged path's own expression), and the
same float32 additions in stack order.

``packed_int_accumulate`` (homoqsgd's exact packed hop) is not ported yet;
``hop_hbm_bytes``, a model of TPU HBM traffic, is not ported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from grace_tpu_torch.ops import _build
from grace_tpu_torch.ops.packing import PACKERS

__all__ = ["decode_accumulate", "decode_accumulate_plain",
           "packed_int_accumulate", "WIRE_WIDTHS"]

# The pack widths decoded here: the sign mask plus qsgd's two's-complement
# fields (ops/packing.py declares the layouts).
WIRE_WIDTHS = (1, 2, 3, 4)


def _check_args(stacked: torch.Tensor, scales: torch.Tensor, numel: int,
                width: int, sign: bool, vote: bool) -> None:
    if width not in WIRE_WIDTHS:
        raise ValueError(f"width must be one of {WIRE_WIDTHS}; got {width}")
    if sign and width != 1:
        raise ValueError("sign decode is the 1-bit mask path")
    if vote and not sign:
        raise ValueError("vote re-sign only applies to the sign path")
    nbytes = -(-numel * width // 8)
    if (stacked.dim() != 2 or stacked.dtype != torch.uint8
            or stacked.shape[0] < 1 or stacked.shape[1] < nbytes):
        raise ValueError(f"decode_accumulate takes (K >= 1, >= {nbytes}) "
                         f"uint8 payloads; got {stacked.dtype} of shape "
                         f"{tuple(stacked.shape)}")
    if (scales.dtype != torch.float32 or scales.numel() != stacked.shape[0]
            or scales.device != stacked.device):
        raise ValueError(f"scales must be {stacked.shape[0]} float32 values "
                         f"on {stacked.device}")


def decode_accumulate_plain(stacked: torch.Tensor, scales: torch.Tensor,
                            numel: int, width: int, sign: bool = False,
                            vote: bool = False) -> torch.Tensor:
    """``(K, nbytes)`` uint8 payloads in accumulation order and their
    ``(K,)`` float32 decode scales → the length-``numel`` float32 partial
    ``Σ_k scale_k·level_k`` (or ``Σ ±1`` with ``sign``; ``vote`` re-signs
    the sum, ties to +1); the plain version of the kernel."""
    _check_args(stacked, scales, numel, width, sign, vote)
    mask = float(1 << width)
    half = float(1 << (width - 1))
    unpack = PACKERS[width][1]
    acc = None
    for k in range(stacked.shape[0]):
        code = unpack(stacked[k], numel).to(torch.float32)
        if sign:
            val = code * 2.0 - 1.0
        else:
            level = code - mask * (code >= half).to(torch.float32)
            val = scales[k] * level
        acc = val if acc is None else acc + val
    if vote:
        acc = (acc >= 0).to(torch.float32) * 2.0 - 1.0
    return acc


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("wire")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.grace_decode_accumulate.argtypes = [p, p, p, i64, i64, i64, i32, i32,
                                            i32, p]
    lib.grace_decode_accumulate.restype = ctypes.c_int
    return lib


def decode_accumulate(stacked: torch.Tensor, scales: torch.Tensor,
                      numel: int, width: int, sign: bool = False,
                      vote: bool = False) -> torch.Tensor:
    """Fused decode→accumulate of K packed payloads into one float32
    partial, one pass over the output. Bit-identical to
    :func:`decode_accumulate_plain`."""
    if stacked.device.type == "cpu":
        return decode_accumulate_plain(stacked, scales, numel, width, sign,
                                       vote)
    if stacked.device.type != "cuda":
        raise ValueError(f"no decode_accumulate for {stacked.device}")
    _check_args(stacked, scales, numel, width, sign, vote)
    stacked = stacked.contiguous()
    scales = scales.contiguous()
    out = torch.empty(numel, dtype=torch.float32, device=stacked.device)
    if numel:
        with torch.cuda.device(stacked.device):
            err = _lib().grace_decode_accumulate(
                stacked.data_ptr(), scales.data_ptr(), out.data_ptr(),
                stacked.shape[0], stacked.shape[1], numel, int(width),
                int(sign), int(vote),
                torch.cuda.current_stream(stacked.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"decode_accumulate: CUDA kernel launch "
                               f"failed with cudaError_t {err}")
        decode_accumulate.launches += 1
    return out


decode_accumulate.launches = 0


def packed_int_accumulate(stacked: torch.Tensor, numel: int, width: int):
    """homoqsgd's exact packed hop (``pallas_wire.packed_int_accumulate``):
    not ported yet."""
    raise NotImplementedError(
        "packed_int_accumulate serves the shared-scale homoqsgd codec and "
        "comes with it (ROADMAP queue 1, slice C)")


def reset_launch_counts() -> None:
    decode_accumulate.launches = 0
