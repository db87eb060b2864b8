"""SignSGD with majority-vote aggregation, and Signum; counterpart of the JAX
package's ``compressors/signsgd.py``.

The wire is the sign mask ``x >= 0`` packed 8 per byte; decode is ``±1``;
``aggregate`` is the majority vote (sum, then re-sign with ties to +1);
``average=False``. Sign extraction is deterministic, so the kernel path
(``use_pallas`` True or ``'auto'``: ``ops/quant.sign_pack`` and the sign
branch of ``ops/wire.decode_accumulate``) and the staged path
(``use_pallas=False``) agree bit for bit everywhere.
"""

from __future__ import annotations

import dataclasses

import torch

from grace_tpu_torch.core import Compressor, Ctx, LeafKey, Payload, State
from grace_tpu_torch.ops import quant, wire
from grace_tpu_torch.ops.packing import pack_bits, unpack_bits


def _signs_to_float(bits: torch.Tensor, dtype) -> torch.Tensor:
    return bits.to(dtype) * 2 - 1


@dataclasses.dataclass(frozen=True)
class SignSGDCompressor(Compressor):
    average = False
    vote_aggregate = True   # aggregate IS the majority vote
    # Re-signing a ring partial at each hop is a cascaded vote.
    supports_hop_requant = True
    # Packed sign bytes do not sum: no payload algebra.
    payload_algebra = None

    use_pallas: bool | str = "auto"

    def __post_init__(self):
        if not (self.use_pallas == "auto" or self.use_pallas is True
                or self.use_pallas is False):
            raise ValueError(f"use_pallas must be True, False or 'auto'; "
                             f"got {self.use_pallas!r}")

    def _kernels(self) -> bool:
        return self.use_pallas is not False

    def _pack(self, flat: torch.Tensor) -> torch.Tensor:
        if self._kernels():
            return quant.sign_pack(flat)
        return pack_bits(flat >= 0)

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        packed = self._pack(x.reshape(-1))
        return (packed,), (x.numel(), tuple(x.shape), x.dtype), state

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        (packed,) = payload
        numel, shape, dtype = ctx
        return _signs_to_float(unpack_bits(packed, numel), dtype).reshape(shape)

    def aggregate(self, stacked: torch.Tensor) -> torch.Tensor:
        summed = torch.sum(stacked, dim=0)
        return (summed >= 0).to(stacked.dtype) * 2 - 1

    def wire_fused(self) -> bool:
        return self._kernels()

    def decode_accumulate(self, payloads, ctxs):
        """The sign hop's decode: K packed masks → the sum of their ±1 in
        one kernel, bit-identical to the staged ``decompress +
        decompress`` (small integers, exact in float32)."""
        numel, shape, dtype = ctxs[0]
        if (not self._kernels() or dtype != torch.float32
                or any(tuple(c) != (numel, shape, dtype) for c in ctxs)):
            return super().decode_accumulate(payloads, ctxs)
        stacked = torch.stack([p[0] for p in payloads])
        scales = torch.ones(stacked.shape[0], dtype=torch.float32,
                            device=stacked.device)
        out = wire.decode_accumulate(stacked, scales, numel, 1, sign=True)
        return out.reshape(shape)


@dataclasses.dataclass(frozen=True)
class SignumCompressor(SignSGDCompressor):
    """SignSGD on a momentum-filtered gradient. The per-leaf state is
    ``{"momentum": flat tensor, "initialized": bool tensor}``, as in the
    JAX package; the first step sends the raw gradient's sign."""

    # Stateful: the shard-parallel communicators reject it, so it does not
    # advertise hop requant; sign bytes have no algebra.
    payload_algebra = None
    supports_hop_requant = False

    momentum: float = 0.9

    def init_state(self, x: torch.Tensor) -> State:
        return {"momentum": torch.zeros(x.numel(), dtype=x.dtype,
                                        device=x.device),
                "initialized": torch.zeros((), dtype=torch.bool,
                                           device=x.device)}

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        flat = x.reshape(-1)
        blended = ((1.0 - self.momentum) * flat
                   + self.momentum * state["momentum"])
        m = torch.where(state["initialized"], blended, flat)
        new_state = {"momentum": m,
                     "initialized": torch.ones((), dtype=torch.bool,
                                               device=x.device)}
        return ((self._pack(m),), (x.numel(), tuple(x.shape), x.dtype),
                new_state)
