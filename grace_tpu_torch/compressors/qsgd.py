"""QSGD stochastic quantization; counterpart of the JAX package's
``compressors/qsgd.py``.

Levels ``floor(|x|·q/‖x‖) + Bernoulli(frac)`` with the sign folded in,
decoded as ``‖x‖/q · level``. The wire is ``(levels, norm)``: int8 levels
when ``quantum_num < 128``, int16 above, and for ``quantum_num <= 7`` the
levels clamped to ``±q`` and packed as two's-complement sub-byte codes
(:attr:`QSGDCompressor.pack_width`: 2-bit at q ≤ 1, a 3-bit bitstream at
q ≤ 3, 4-bit at q ≤ 7). The norm stays a device tensor.

``use_pallas`` keeps its JAX name so the JAX params dicts build unchanged.
``False`` selects the staged tensor path, which draws its uniforms with
``torch.rand`` from the leaf's generator. ``True`` and ``'auto'`` select
the kernels of ``ops/quant.py`` (encode, family ``quant``) and
``ops/wire.py`` (the ring hop's decode→accumulate, family ``wire``),
which launch the CUDA kernels for CUDA tensors and run their plain
versions for CPU tensors; their random bits are the counter hash under a
seed drawn from the leaf's key. The environment can turn either family
off (``ops.pallas_mode``), as in the JAX package.

The decode scale ``norm / q`` is ``norm * core.mean_scale(q)``: XLA
compiles the JAX package's division by the constant ``q`` into that
multiplication, so the two packages decode identical levels to identical
bits. The encode scale ``q / norm`` divides by a runtime value and stays a
true division.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from grace_tpu_torch.core import (Compressor, Ctx, LeafKey, Payload, State,
                                  mean_scale)
from grace_tpu_torch.ops import pallas_mode, quant, wire
from grace_tpu_torch.ops.packing import PACKERS


def _numel(shape) -> int:
    return math.prod(shape)


@dataclasses.dataclass(frozen=True)
class QSGDCompressor(Compressor):
    # Re-quantizing a ring partial is QSGD applied to a fresh tensor.
    supports_hop_requant = True
    # Levels decode against each rank's own norm: no payload algebra.
    payload_algebra = None

    quantum_num: int = 64
    use_pallas: bool | str = "auto"

    def __post_init__(self):
        if not (self.use_pallas == "auto" or self.use_pallas is True
                or self.use_pallas is False):
            raise ValueError(f"use_pallas must be True, False or 'auto'; "
                             f"got {self.use_pallas!r}")
        if (not isinstance(self.quantum_num, int)
                or not 1 <= self.quantum_num <= 32767):
            raise ValueError(f"quantum_num must be an int in [1, 32767] (the "
                             f"int16 wire's range); got {self.quantum_num!r}")

    @property
    def packed_wire(self) -> bool:
        """True iff the payload ships sub-byte packed codes (q ≤ 7)."""
        return self.quantum_num <= 7

    @property
    def pack_width(self) -> int:
        """Two's-complement field width of the packed wire: the narrowest
        of {2, 3, 4} whose ceiling ``2^(w-1) - 1`` holds ``quantum_num``."""
        if self.quantum_num <= 1:
            return 2
        if self.quantum_num <= 3:
            return 3
        return 4

    @property
    def level_dtype(self) -> torch.dtype:
        return torch.int8 if self.quantum_num < 128 else torch.int16

    def decode_scale(self, norm: torch.Tensor) -> torch.Tensor:
        """``norm / q`` as XLA computes it: ``norm * float32(1/q)``."""
        return norm * mean_scale(self.quantum_num)

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        shape = tuple(x.shape)
        flat = x.reshape(-1)
        norm = torch.linalg.vector_norm(flat)
        q = self.quantum_num
        if pallas_mode(self.use_pallas, "quant"):
            seed = rng.seed_int32()
            if self.packed_wire:
                packed = quant.quantize_pack_stochastic(
                    flat, norm, seed, q, width=self.pack_width)
                return (packed, norm), (shape, x.dtype), state
            signed = quant.quantize_stochastic(flat, norm, seed, q,
                                               out_dtype=self.level_dtype)
            return (signed, norm), (shape, x.dtype), state
        u = rng.uniform(flat.shape, flat.device)
        signed = quant.signed_levels_plain(flat, norm, u, q)
        if self.packed_wire:
            payload = quant.pack_levels_plain(signed, q, self.pack_width)
        else:
            payload = quant.saturate_levels_plain(signed, self.level_dtype)
        return (payload, norm), (shape, x.dtype), state

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        levels, norm = payload
        shape, dtype = ctx
        if self.packed_wire:
            w = self.pack_width
            codes = PACKERS[w][1](levels, _numel(shape)).to(torch.int8)
            levels = torch.where(codes >= (1 << (w - 1)), codes - (1 << w),
                                 codes)
        out = self.decode_scale(norm) * levels.to(dtype)
        return out.reshape(shape)

    def wire_fused(self) -> bool:
        """True exactly when :meth:`decode_accumulate` takes its kernel:
        the ``wire`` family on and the payload packed."""
        return self.packed_wire and pallas_mode(self.use_pallas, "wire")

    def decode_accumulate(self, payloads, ctxs):
        """The ring hop's decode: K packed payloads → one float32 partial
        through the decode→accumulate kernel, bit-identical to the staged
        ``decompress + decompress`` (same unpack, same sign extension, same
        per-payload ``norm * mean_scale(q)``, same order of additions).
        The staged spelling runs when the ``wire`` family is off, the
        wire is not packed, the decode dtype is not float32, or the ctxs
        differ. The payloads are stacked into rows that start on 16
        bytes (``wire.stack_payloads``)."""
        shape, dtype = ctxs[0]
        if (not self.wire_fused() or dtype != torch.float32
                or any(tuple(c[:2]) != (shape, dtype) for c in ctxs)):
            return super().decode_accumulate(payloads, ctxs)
        stacked = wire.stack_payloads([p[0] for p in payloads])
        scales = torch.stack([self.decode_scale(p[1].reshape(()).float())
                              for p in payloads])
        out = wire.decode_accumulate(stacked, scales, _numel(shape),
                                     self.pack_width)
        return out.reshape(shape)
