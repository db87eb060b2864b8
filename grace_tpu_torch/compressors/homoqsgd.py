"""Homomorphic (shared-scale) QSGD; counterpart of the JAX package's
``compressors/homoqsgd.py``.

Plain QSGD scales each rank's levels by that rank's own norm, so payloads
of different ranks do not add. This codec negotiates one scale first:

1. **negotiate** — an all-reduce MAX of the local max magnitude over the
   group (a float32 scalar); every rank then holds the same scale, and the
   communicators run it before the stage-1 encode;
2. **encode** — stochastic rounding of ``quantum_num * |x| / scale`` to
   signed integer levels in ``[-quantum_num, quantum_num]``, shipped in
   ``accum_dtype`` (int8/16/32), or with ``accum_bits`` ∈ {2, 3, 4} packed
   as two's-complement fields of that width (``ops/packing.py``);
3. **aggregate** — ring hops and the reduce-scatter's owned-chunk sum add
   the integer levels in payload space (for the packed wire: a field-wise
   add mod ``2^accum_bits``, the ``packed_int_accumulate`` kernel over the
   payloads where they lie), and one decode at the end gives
   ``scale / quantum_num * summed_levels``.

The sums are exact up to :meth:`HomoQSGDCompressor.payload_sum_max_world`
ranks, the bound the communicators' homomorphic paths enforce.

The encode is staged tensor code in both packages (there is no quantize
kernel for this codec). Its uniforms come from ``LeafKey.uniform``. The
encode scale ``q / scale`` divides by a runtime value and stays a true
division (``ops/quant.encode_scale_plain``); the decode scale ``scale / q``
divides by a constant, which XLA compiles into ``scale * float32(1/q)``,
so the port spells it ``scale * core.mean_scale(q)``.

``use_pallas`` keeps its JAX name: ``False`` (or the ``wire`` family
turned off by the environment: ``ops.pallas_mode``) runs the packed
accumulate as staged tensor code, ``True`` and ``'auto'`` through
``ops/wire.packed_int_accumulate_rows`` (the CUDA kernel for CUDA
tensors, its plain version for CPU tensors). Both are integer-exact, so
the knob moves only where the add runs.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from grace_tpu_torch.core import (Compressor, Ctx, LeafKey, Payload, State,
                                  mean_scale)
from grace_tpu_torch.ops import pallas_mode, quant, wire
from grace_tpu_torch.ops.packing import PACKERS
from grace_tpu_torch.telemetry import counters

_ACCUM_DTYPES = ("int8", "int16", "int32", "int64")


@dataclasses.dataclass(frozen=True)
class HomoQSGDCompressor(Compressor):
    # Integer levels under one negotiated scale: payloads add exactly.
    payload_algebra = "shared_scale"
    # A hop requant would bring back the per-hop loss the shared scale
    # removes; the homomorphic path never requantizes.
    supports_hop_requant = False

    quantum_num: int = 7          # 4-bit levels, the qsgd4 wire family
    accum_dtype: str = "int16"    # payload/accumulator width (int8/16/32)
    # None ships accum_dtype levels; 2/3/4 packs them into two's-complement
    # fields of that width, which are then both the wire word and the hop
    # accumulator.
    accum_bits: int | None = None
    use_pallas: bool | str = "auto"

    def __post_init__(self):
        if not (self.use_pallas == "auto" or self.use_pallas is True
                or self.use_pallas is False):
            raise ValueError(f"use_pallas must be True, False or 'auto'; "
                             f"got {self.use_pallas!r}")
        if self.accum_bits is not None:
            if self.accum_bits not in wire.ACCUM_WIDTHS:
                raise ValueError(f"accum_bits must be 2, 3, 4 or None; "
                                 f"got {self.accum_bits}")
            ceil = (1 << (self.accum_bits - 1)) - 1
            if self.quantum_num > ceil:
                raise ValueError(
                    f"quantum_num={self.quantum_num} does not fit ONE "
                    f"rank's level in a {self.accum_bits}-bit two's-"
                    f"complement field (magnitude <= {ceil})")
        if self.accum_dtype not in _ACCUM_DTYPES:
            raise ValueError(f"accum_dtype must be a signed integer dtype "
                             f"(the payload IS the accumulator); got "
                             f"{self.accum_dtype!r}")
        if self.quantum_num < 1:
            raise ValueError(f"quantum_num must be >= 1; got "
                             f"{self.quantum_num}")
        top = torch.iinfo(self.level_dtype).max
        if self.quantum_num > top:
            raise ValueError(
                f"quantum_num={self.quantum_num} does not even fit ONE "
                f"rank's level in {self.accum_dtype} (max {top})")

    @property
    def level_dtype(self) -> torch.dtype:
        return getattr(torch, self.accum_dtype)

    @property
    def packed_fields(self) -> bool:
        """True when each payload byte holds several level fields, which an
        element-wise byte sum would corrupt (carries cross the fields)."""
        return self.accum_bits is not None

    def payload_sum_max_world(self) -> int:
        """Largest world whose payload-space sum stays exact: a W-rank sum
        lies in ``[-W·q, W·q]``, exact while ``W·q`` fits the accumulator's
        positive range, the field's ``2^(accum_bits-1) - 1`` in packed mode
        and ``iinfo(accum_dtype).max`` otherwise."""
        if self.accum_bits is not None:
            ceil = (1 << (self.accum_bits - 1)) - 1
        else:
            ceil = torch.iinfo(self.level_dtype).max
        return ceil // self.quantum_num

    # -- negotiation ---------------------------------------------------------

    def negotiate(self, x: torch.Tensor, group, rng: LeafKey = None
                  ) -> torch.Tensor:
        """The shared scale: an all-reduce MAX of the local max magnitude,
        in float32, over ``group``. Every rank ends with the same value."""
        local = x.reshape(-1).abs().max().float().reshape(1)
        counters.count("all_reduce", local)
        dist.all_reduce(local, op=dist.ReduceOp.MAX, group=group)
        return local.reshape(())

    def negotiation_nbytes(self, world: int) -> int:
        # One float32 through a ring-style reduction: 2·4·(W−1)/W bytes.
        return 2 * 4 * max(0, world - 1) // max(1, world)

    # -- codec ---------------------------------------------------------------

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey,
                 shared=None) -> tuple[Payload, Ctx, State]:
        """Encode against ``shared`` (the negotiated scale), or against the
        local max magnitude where no negotiation ran: that decodes this
        rank's own payload, but does not sum across ranks."""
        shape = tuple(x.shape)
        flat = x.reshape(-1)
        scale = (shared.float().reshape(()) if shared is not None
                 else flat.abs().max().float())
        q = self.quantum_num
        u = rng.uniform(flat.shape, flat.device)
        # |x| <= scale under the negotiated scale, so the levels lie in
        # ±q already; the clamp only guards the local fallback's edges.
        signed = quant.signed_levels_plain(flat, scale, u, q).clamp(-q, q)
        if self.accum_bits is not None:
            payload = quant.pack_levels_plain(signed, q, self.accum_bits)
        else:
            payload = signed.to(self.level_dtype)
        return (payload,), (shape, x.dtype, scale), state

    def _unpack_levels(self, packed: torch.Tensor, n: int) -> torch.Tensor:
        w = self.accum_bits
        code = PACKERS[w][1](packed, n).to(torch.int32)
        return code - (1 << w) * (code >= (1 << (w - 1))).to(torch.int32)

    def _packed_accumulate(self, rows) -> torch.Tensor:
        """K packed ``nbytes`` payloads (separate tensors, or the rows of
        a ``(K, nbytes)`` stack) → the packed level sum, over every code
        slot the bytes hold (the tail slots are zero by the packers'
        padding, so the sum is exact and keeps the length). The kernel
        reads the payloads where they lie."""
        w = self.accum_bits
        n_slots = rows[0].numel() * 8 // w
        if self.wire_fused():
            return wire.packed_int_accumulate_rows(rows, n_slots, w)
        levels = sum(self._unpack_levels(p, n_slots) for p in rows)
        return PACKERS[w][0](torch.remainder(levels, 1 << w).to(torch.uint8))

    def wire_fused(self) -> bool:
        """True exactly when the packed accumulate takes its kernel."""
        return (self.accum_bits is not None
                and pallas_mode(self.use_pallas, "wire"))

    def payload_add(self, a: Payload, b: Payload) -> Payload:
        if self.accum_bits is None:
            return super().payload_add(a, b)
        return (self._packed_accumulate((a[0], b[0])),)

    def payload_sum(self, stacked: Payload) -> Payload:
        if self.accum_bits is None:
            return super().payload_sum(stacked)
        return (self._packed_accumulate(stacked[0].unbind(0)),)

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        """Linear in the (possibly summed) levels: ``scale/q · levels``,
        so the decode of the sum is the sum of the decodes."""
        (levels,) = payload
        shape, dtype, scale = ctx
        if self.accum_bits is not None:
            levels = self._unpack_levels(levels, math.prod(shape))
        out = (scale * mean_scale(self.quantum_num)) * levels.to(
            torch.float32)
        return out.reshape(shape).to(dtype)
