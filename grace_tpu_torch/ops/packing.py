"""Bit-packing primitives for sub-byte wire payloads.

Counterpart of the JAX package's ``ops/packing.py``, in plain torch. Every
packer is LSB-first and emits exactly ``ceil(n·w/8)`` bytes:

* widths that divide 8 (1, 2, 4) put ``8/w`` consecutive codes into one
  byte, the first code in the lowest bits;
* 3-bit codes form one bitstream: bit ``b`` of code ``l`` is global bit
  ``3l + b``, and bit ``k`` of byte ``j`` is global bit ``8j + k``, so codes
  straddle byte boundaries.

A zero-padded final byte carries code 0 in its unused lanes. These layouts
are the wire contract that the CUDA kernels of ``ops/quant.py`` and
``ops/wire.py`` produce and consume.
"""

from __future__ import annotations

import torch


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def pack_widths():
    """The declared ``(bits-per-code, pack, unpack)`` contract of this
    module: every packer round-trips codes up to ``2**bits - 1`` and emits
    exactly ``ceil(n*bits/8)`` bytes."""
    return ((1, pack_bits, unpack_bits), (2, pack_2bit, unpack_2bit),
            (3, pack_3bit, unpack_3bit), (4, pack_4bit, unpack_4bit))


def _pack_lanes(codes: torch.Tensor, width: int) -> torch.Tensor:
    """Pack 1-D codes of a width dividing 8 into uint8, ``8/width`` per
    byte, the first code in the lowest bits."""
    per_byte = 8 // width
    n = codes.shape[0]
    nbytes = _ceil_div(n, per_byte)
    padded = torch.zeros(nbytes * per_byte, dtype=torch.uint8,
                         device=codes.device)
    padded[:n] = codes.to(torch.uint8)
    shifts = torch.arange(0, 8, width, dtype=torch.uint8, device=codes.device)
    # Lanes occupy disjoint bits, so a sum equals the bitwise OR.
    return torch.sum(padded.view(nbytes, per_byte) << shifts, dim=1,
                     dtype=torch.uint8)


def _unpack_lanes(packed: torch.Tensor, n: int, width: int) -> torch.Tensor:
    shifts = torch.arange(0, 8, width, dtype=torch.uint8, device=packed.device)
    codes = (packed[:, None] >> shifts) & ((1 << width) - 1)
    return codes.reshape(-1)[:n]


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a 1-D boolean/0-1 tensor into uint8, 8 values per byte."""
    return _pack_lanes(bits, 1)


def unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`; returns a bool tensor of length ``n``."""
    return _unpack_lanes(packed, n, 1).bool()


def pack_2bit(codes: torch.Tensor) -> torch.Tensor:
    """Pack 1-D 2-bit codes (0..3) into uint8, 4 per byte."""
    return _pack_lanes(codes, 2)


def unpack_2bit(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_2bit`; returns uint8 codes of length ``n``."""
    return _unpack_lanes(packed, n, 2)


def pack_3bit(codes: torch.Tensor) -> torch.Tensor:
    """Pack 1-D 3-bit codes (0..7) into ``ceil(3n/8)`` uint8 bytes as one
    LSB-first bitstream."""
    n = codes.shape[0]
    nbytes = _ceil_div(3 * n, 8)
    dev = codes.device
    shifts = torch.arange(3, dtype=torch.uint8, device=dev)
    bits = ((codes.to(torch.uint8)[:, None] >> shifts) & 1).reshape(-1)
    padded = torch.zeros(nbytes * 8, dtype=torch.uint8, device=dev)
    padded[:3 * n] = bits
    byte_shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    return torch.sum(padded.view(nbytes, 8) << byte_shifts, dim=1,
                     dtype=torch.uint8)


def unpack_3bit(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_3bit`; returns uint8 codes of length ``n``."""
    dev = packed.device
    byte_shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    bits = ((packed[:, None] >> byte_shifts) & 1).reshape(-1)
    trip = bits[:3 * n].reshape(n, 3)
    shifts = torch.arange(3, dtype=torch.uint8, device=dev)
    return torch.sum(trip << shifts, dim=1, dtype=torch.uint8)


def pack_4bit(codes: torch.Tensor) -> torch.Tensor:
    """Pack 1-D 4-bit codes (0..15) into uint8, 2 per byte (low nibble
    first)."""
    return _pack_lanes(codes, 4)


def unpack_4bit(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_4bit`; returns uint8 codes of length ``n``."""
    return _unpack_lanes(packed, n, 4)


PACKERS = {w: (pack, unpack) for w, pack, unpack in pack_widths()}
