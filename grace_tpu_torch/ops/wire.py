"""The decode side of the wire path: K packed payloads → one float32
partial, and K packed level payloads → their packed integer sum.

Counterpart of the JAX package's ``ops/pallas_wire.py``, in the pattern of
``ops/chunk_topk.py``. Each kernel has a plain PyTorch version (the
oracle, and what runs for CPU tensors: :func:`decode_accumulate_plain`,
:func:`packed_int_accumulate_plain`), a wrapper that launches the
hand-written kernel of ``grace_tpu_torch/csrc/wire.cu`` for CUDA tensors or
raises, and a ``.launches`` counter on the wrapper.

The bit-identity contract of ``decode_accumulate`` is the JAX package's:
the fused decode equals the staged sequential ``decompress(payload_0) +
decompress(payload_1) + …`` — the same unpack layout, the same sign
extension, the same per-payload scale (pre-divided by the caller with the
staged path's own expression), and the same float32 additions in stack
order. ``packed_int_accumulate`` is integer arithmetic only: a field's
level is its code mod ``2^width``, so the sum that homoqsgd's staged
unpack → add → repack folds with a floored mod is the per-field sum of the
codes mod ``2^width``, which the kernel adds without unpacking.
``packed_int_accumulate_rows`` is the same kernel over payloads given as
separate tensors, and counts its launches on
``packed_int_accumulate.launches``.

``hop_hbm_bytes``, a model of TPU HBM traffic, is not ported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from grace_tpu_torch.ops import _build
from grace_tpu_torch.ops import fake as _fake
from grace_tpu_torch.ops.packing import PACKERS

__all__ = ["decode_accumulate", "decode_accumulate_plain", "stack_payloads",
           "packed_int_accumulate", "packed_int_accumulate_rows",
           "packed_int_accumulate_plain", "WIRE_WIDTHS", "ACCUM_WIDTHS",
           "ROW_ALIGN", "ACCUM_ROW_TILE"]

# The pack widths decoded here: the sign mask plus qsgd's two's-complement
# fields (ops/packing.py declares the layouts).
WIRE_WIDTHS = (1, 2, 3, 4)
# The two's-complement field widths that homoqsgd's packed levels ride.
ACCUM_WIDTHS = (2, 3, 4)
# The decode kernel reads payload rows that start on 16-byte boundaries
# with 16-byte loads (others with byte loads).
ROW_ALIGN = 16
# Rows a launch of the packed accumulate (its row table, kMaxRows in
# csrc/wire.cu); more run as launches that chain through the output.
ACCUM_ROW_TILE = 32


def stack_payloads(payloads) -> torch.Tensor:
    """K equal-length uint8 payloads → a ``(K, nbytes)`` view of a buffer
    whose rows are ``nbytes`` rounded up to ``ROW_ALIGN`` bytes, so that
    every row starts on a 16-byte boundary for :func:`decode_accumulate`.
    The one copy ``torch.stack`` makes, into the padded rows."""
    nbytes = payloads[0].numel()
    pitch = -(-nbytes // ROW_ALIGN) * ROW_ALIGN
    buf = torch.empty((len(payloads), pitch), dtype=torch.uint8,
                      device=payloads[0].device)
    return torch.stack(payloads, out=buf[:, :nbytes])


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
    """``(K, >= nbytes)`` uint8 payloads in accumulation order and their
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
    lib.grace_decode_accumulate.argtypes = [p, i64, p, p, i64, i64, i64, i32,
                                            i32, i32, p]
    lib.grace_decode_accumulate.restype = ctypes.c_int
    lib.grace_packed_int_accumulate.argtypes = [p, i64, p, i64, i64, i32,
                                                p]
    lib.grace_packed_int_accumulate.restype = ctypes.c_int
    return lib


def decode_accumulate(stacked: torch.Tensor, scales: torch.Tensor,
                      numel: int, width: int, sign: bool = False,
                      vote: bool = False) -> torch.Tensor:
    """Fused decode→accumulate of K packed payloads into one float32
    partial, one pass over the output. ``stacked``'s rows may lie at any
    stride (``stacked.stride(1) == 1``): the kernel reads them in place,
    with 16-byte loads where every row starts on 16 bytes
    (:func:`stack_payloads` stacks them so). Bit-identical to
    :func:`decode_accumulate_plain`."""
    if stacked.device.type == "cpu":
        return decode_accumulate_plain(stacked, scales, numel, width, sign,
                                       vote)
    if stacked.device.type != "cuda":
        raise ValueError(f"no decode_accumulate for {stacked.device}")
    _check_args(stacked, scales, numel, width, sign, vote)
    if stacked.stride(1) != 1 and stacked.shape[1] > 1:
        raise ValueError(f"decode_accumulate reads each payload row as "
                         f"bytes in order; got strides {stacked.stride()}")
    scales = scales.contiguous()
    if _fake.is_fake(stacked) and numel:
        return _fake.launch("decode_accumulate", [stacked, scales],
                            lambda: _fresh(numel, torch.float32,
                                           stacked.device))
    out = torch.empty(numel, dtype=torch.float32, device=stacked.device)
    if numel:
        with torch.cuda.device(stacked.device):
            err = _lib().grace_decode_accumulate(
                stacked.data_ptr(), stacked.stride(0), scales.data_ptr(),
                out.data_ptr(), stacked.shape[0], stacked.shape[1], numel,
                int(width), int(sign), int(vote),
                torch.cuda.current_stream(stacked.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"decode_accumulate: CUDA kernel launch "
                               f"failed with cudaError_t {err}")
        decode_accumulate.launches += 1
    return out


decode_accumulate.launches = 0


def _check_accum_args(stacked: torch.Tensor, numel: int, width: int) -> None:
    if width not in ACCUM_WIDTHS:
        raise ValueError(f"width must be one of {ACCUM_WIDTHS}; got {width}")
    if (stacked.dim() != 2 or stacked.dtype != torch.uint8
            or stacked.shape[0] < 1
            or stacked.shape[1] < -(-numel * width // 8) or numel < 0):
        raise ValueError(
            f"packed_int_accumulate takes (K >= 1, >= ceil(numel*width/8)) "
            f"uint8 payloads; got {stacked.dtype} of shape "
            f"{tuple(stacked.shape)} for numel={numel}, width={width}")


def packed_int_accumulate_plain(stacked: torch.Tensor, numel: int,
                                width: int) -> torch.Tensor:
    """``(K, nbytes)`` uint8 payloads of ``width``-bit two's-complement
    levels → one ``nbytes`` uint8 payload of their sums; the plain version
    of the kernel, and homoqsgd's staged spelling: unpack the first
    ``numel`` codes of each payload LSB-first, sign-extend, add in int32,
    fold with a floored ``mod 2^width`` (exact while the sums fit the
    field, the ``payload_sum_max_world`` bound; a wrap beyond it) and
    repack. Code slots from ``numel`` on come out 0."""
    _check_accum_args(stacked, numel, width)
    pack, unpack = PACKERS[width]
    acc = torch.zeros(numel, dtype=torch.int32, device=stacked.device)
    for k in range(stacked.shape[0]):
        code = unpack(stacked[k], numel).to(torch.int32)
        acc += code - (1 << width) * (code >= (1 << (width - 1))).to(
            torch.int32)
    packed = pack(torch.remainder(acc, 1 << width).to(torch.uint8))
    out = torch.zeros(stacked.shape[1], dtype=torch.uint8,
                      device=stacked.device)
    out[:packed.numel()] = packed
    return out


def row_tiles(rows: list, out) -> list:
    """The launches of the packed accumulate over ``rows``: the first
    ``ACCUM_ROW_TILE`` rows, then ``out`` (the sum so far) and up to
    ``ACCUM_ROW_TILE - 1`` more rows a launch. Exact because the per-field
    sum mod ``2^width`` is associative."""
    first, rest = rows[:ACCUM_ROW_TILE], rows[ACCUM_ROW_TILE:]
    return [first] + [[out] + rest[i:i + ACCUM_ROW_TILE - 1]
                      for i in range(0, len(rest), ACCUM_ROW_TILE - 1)]


def _fresh(n: int, dtype, device):
    """A fake launch's ``(result, written)``: one fresh output."""
    out = torch.empty(n, dtype=dtype, device=device)
    return out, (out,)


def _fake_accumulate(reads, k: int, nbytes: int, device) -> torch.Tensor:
    """The fake launches of :func:`_accumulate_rows` over ``k`` rows of
    ``nbytes``: one node a launch of :func:`row_tiles`, each writing the
    output (and the later ones reading it too)."""
    out = torch.empty(nbytes, dtype=torch.uint8, device=device)
    if not nbytes:
        return out
    for i, tile in enumerate(row_tiles(list(range(k)), out)):
        _fake.launch("packed_int_accumulate",
                     list(reads) + ([out] if i else []),
                     lambda: (out, (out,)))
    return out


def _accumulate_rows(ptrs, nbytes: int, numel: int, width: int,
                     device: torch.device) -> torch.Tensor:
    """Launch the kernel over the rows at the device addresses ``ptrs``
    (each ``nbytes`` long, at any alignment), in the launches of
    :func:`row_tiles`."""
    out = torch.empty(nbytes, dtype=torch.uint8, device=device)
    if not nbytes:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        lib = _lib()
        for tile in row_tiles(ptrs, out.data_ptr()):
            err = lib.grace_packed_int_accumulate(
                (ctypes.c_void_p * len(tile))(*tile), len(tile),
                out.data_ptr(), nbytes, numel, int(width), stream)
            if err != 0:
                raise RuntimeError(f"packed_int_accumulate: CUDA kernel "
                                   f"launch failed with cudaError_t {err}")
            packed_int_accumulate.launches += 1
    return out


def packed_int_accumulate(stacked: torch.Tensor, numel: int, width: int
                          ) -> torch.Tensor:
    """The exact payload-space accumulate of packed ``shared_scale``
    levels: K packed payloads in, one packed payload of the integer level
    sums out, in one pass, with no unpacked intermediate. ``stacked``'s
    rows may lie at any stride (``stacked.stride(1) == 1``): the kernel
    reads them in place. Byte-identical to
    :func:`packed_int_accumulate_plain`."""
    if stacked.device.type == "cpu":
        return packed_int_accumulate_plain(stacked, numel, width)
    if stacked.device.type != "cuda":
        raise ValueError(f"no packed_int_accumulate for {stacked.device}")
    _check_accum_args(stacked, numel, width)
    if stacked.stride(1) != 1 and stacked.shape[1] > 1:
        raise ValueError(f"packed_int_accumulate reads each payload row as "
                         f"bytes in order; got strides {stacked.stride()}")
    if _fake.is_fake(stacked):
        return _fake_accumulate([stacked], stacked.shape[0],
                                stacked.shape[1], stacked.device)
    base, pitch = stacked.data_ptr(), stacked.stride(0)
    ptrs = [base + i * pitch for i in range(stacked.shape[0])]
    return _accumulate_rows(ptrs, stacked.shape[1], numel, width,
                            stacked.device)


def packed_int_accumulate_rows(rows, numel: int, width: int
                               ) -> torch.Tensor:
    """:func:`packed_int_accumulate` of K equal-length 1-D uint8 payloads
    given as separate tensors on one device, in accumulation order: the
    kernel reads each where it lies, so the callers stack nothing. On CPU
    tensors, the plain version over ``torch.stack(rows)``."""
    rows = list(rows)
    if not rows:
        raise ValueError("packed_int_accumulate_rows takes K >= 1 payloads")
    first = rows[0]
    for r in rows:
        if (r.dim() != 1 or r.dtype != torch.uint8
                or r.shape != first.shape or r.device != first.device):
            raise ValueError(
                f"packed_int_accumulate_rows takes equal-length 1-D uint8 "
                f"payloads on one device; got {r.dtype} of shape "
                f"{tuple(r.shape)} on {r.device} beside {first.dtype} of "
                f"shape {tuple(first.shape)} on {first.device}")
    if first.device.type == "cpu":
        return packed_int_accumulate_plain(torch.stack(rows), numel, width)
    if first.device.type != "cuda":
        raise ValueError(f"no packed_int_accumulate for {first.device}")
    _check_accum_args(first[None], numel, width)
    if first.numel() > 1 and any(r.stride(0) != 1 for r in rows):
        raise ValueError("packed_int_accumulate_rows reads each payload as "
                         "bytes in order; got a strided row")
    if _fake.is_fake(first):
        return _fake_accumulate(rows, len(rows), first.numel(), first.device)
    return _accumulate_rows([r.data_ptr() for r in rows], first.numel(),
                            numel, width, first.device)


packed_int_accumulate.launches = 0


def reset_launch_counts() -> None:
    decode_accumulate.launches = 0
    packed_int_accumulate.launches = 0
