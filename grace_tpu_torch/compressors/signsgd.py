"""SignSGD with majority-vote aggregation, and Signum; counterpart of the JAX
package's ``compressors/signsgd.py``.

The wire is the sign mask ``x >= 0`` packed 8 per byte; decode is ``±1``;
``aggregate`` is the majority vote (sum, then re-sign with ties to +1);
``average=False``. Sign extraction is deterministic, so the kernel path
(``use_pallas`` True or ``'auto'``: ``ops/quant.sign_pack``, family
``quant``, and the sign branch of ``ops/wire.decode_accumulate``, family
``wire``) and the staged path (``use_pallas=False``, or the family turned
off by the environment: ``ops.pallas_mode``) agree bit for bit
everywhere.

Over many leaves (``fusion="none"`` under the all-reduce vote), the kernel
path packs every leaf whose gates pass in one grouped sign-pack launch
with the error feedback folded in (:meth:`SignSGDCompressor.
fused_feedback_compress_leaves`), and the vote decodes the concatenated
payload in one pass (:meth:`SignSGDCompressor.decompress_leaves`).
"""

from __future__ import annotations

import dataclasses

import torch

from grace_tpu_torch.core import Compressor, Ctx, LeafKey, Payload, State
from grace_tpu_torch.ops import pallas_mode, quant, wire
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

    def _pack(self, flat: torch.Tensor) -> torch.Tensor:
        if pallas_mode(self.use_pallas, "quant"):
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
        """True exactly when the sign decodes take their kernel."""
        return pallas_mode(self.use_pallas, "wire")

    def fused_feedback_compress_leaves(self, xs, states, coeffs, rngs):
        """The grouped compress of the vote's per-leaf path: every leaf
        whose gates pass (float32 and contiguous, with a float32 residual
        of its size under linear feedback ``coeffs = (beta, gamma)``, or no
        state at all when ``coeffs`` is None) in one sign-pack launch that
        compensates, packs and writes the new residual (in place on CUDA).
        The gates read shapes and dtypes only, so every rank takes the same
        leaves. Returns ``(taken, (payload,), ctx, new_states)`` or None
        where no leaf passes or the ``quant`` family is off; per leaf,
        bit-identical to ``compensate → compress → update``."""
        if not pallas_mode(self.use_pallas, "quant"):
            return None
        taken = []
        for i, (x, state) in enumerate(zip(xs, states)):
            if x.dtype != torch.float32 or not x.is_contiguous():
                continue
            if coeffs is None:
                ok = state is None
            else:
                ok = (isinstance(state, torch.Tensor)
                      and state.dtype == torch.float32
                      and state.numel() == x.numel()
                      and state.device == x.device and state.is_contiguous())
            if ok:
                taken.append(i)
        if not taken:
            return None
        grads = [xs[i] for i in taken]
        if coeffs is None:
            payload, _ = quant.sign_pack_grouped(grads)
            new_states = [None] * len(taken)
        else:
            beta, gamma = coeffs
            payload, new_states = quant.sign_pack_grouped(
                grads, [states[i] for i in taken], float(beta), float(gamma))
        plan = quant.sign_plan(tuple(g.numel() for g in grads))
        ctx = (plan, tuple(g.shape for g in grads))
        return taken, (payload,), ctx, new_states

    def decompress_leaves(self, payload, ctx) -> torch.Tensor:
        """The ±1 float32 decode of a grouped payload, one pass over all of
        it (padding lanes included: they decode to -1): leaf ``l`` sits at
        element ``8 * plan.boff[l]``. :meth:`leaf_views` cuts it up. The
        ``wire`` family's kernel, or the staged unpack where it is off."""
        (packed,) = payload
        if not self.wire_fused():
            return _signs_to_float(unpack_bits(packed, packed.numel() * 8),
                                   torch.float32)
        ones = torch.ones(1, dtype=torch.float32, device=packed.device)
        return wire.decode_accumulate(packed[None], ones, packed.numel() * 8,
                                      1, sign=True)

    @staticmethod
    def leaf_views(flat: torch.Tensor, ctx) -> list:
        """Each leaf's tensor of a flat buffer laid out as
        :meth:`decompress_leaves` decodes: views, no copy."""
        plan, shapes = ctx
        return [flat[8 * o:8 * o + n].view(shape) for o, n, shape in
                zip(plan.boff.tolist(), plan.ns, shapes)]

    def decode_accumulate(self, payloads, ctxs):
        """The sign hop's decode: K packed masks → the sum of their ±1 in
        one kernel, bit-identical to the staged ``decompress +
        decompress`` (small integers, exact in float32)."""
        numel, shape, dtype = ctxs[0]
        if (not self.wire_fused() or dtype != torch.float32
                or any(tuple(c) != (numel, shape, dtype) for c in ctxs)):
            return super().decode_accumulate(payloads, ctxs)
        stacked = wire.stack_payloads([p[0] for p in payloads])
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
    # advertise hop requant; sign bytes have no algebra. Its momentum state
    # stays per leaf: no grouped compress.
    payload_algebra = None
    supports_hop_requant = False
    fused_feedback_compress_leaves = None

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
