"""The Compressor / Memory / Communicator pipeline over torch tensors.

Counterpart of the JAX package's ``core.py`` (its ``Compressor``, ``Memory``
and ``Communicator`` classes and ``Communicator.step``). The JAX version
threads every state functionally through ``jit``; here PyTorch runs eagerly,
so the same pipeline is plain Python over tensors. States are still
returned rather than hidden in objects, so the transform can hold them per
gradient leaf exactly as the JAX ``GraceState`` does.

Communicators exchange over a ``torch.distributed`` process group (``None``
= the default group) where the JAX package names a mesh axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# One rank's wire payload: a tuple of tensors.
Payload = Tuple[torch.Tensor, ...]
# Decode context, identical across ranks (static Python data).
Ctx = Any
# Per-leaf cross-step compressor/memory state (often None).
State = Any

def mean_scale(world: int) -> float:
    """The float32 factor of a world-size mean: the correctly rounded
    float32 reciprocal of ``world``. The JAX package writes the mean as
    ``x / world``, and XLA compiles a division by that constant into a
    multiplication by its reciprocal, which differs from a true division
    in the last bit for most ``world`` that are not powers of two. The
    port multiplies by the same factor, so its means match bit for bit."""
    return float(np.float32(1.0) / np.float32(world))


def needs_negotiation(compressor) -> bool:
    """Whether a communicator must run ``compressor.negotiate`` before the
    encode: every ``shared_scale`` codec, plus codecs that declare
    ``negotiates = True``."""
    return (getattr(compressor, "payload_algebra", None) == "shared_scale"
            or getattr(compressor, "negotiates", False))


# -- the per-(step, leaf) generator contract ---------------------------------

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


@dataclasses.dataclass(frozen=True)
class LeafKey:
    """The random stream of one gradient leaf at one step.

    Replaces JAX's ``fold_in(fold_in(key(seed), count), leaf)``. The seed
    of the leaf's ``torch.Generator`` is

        splitmix64(splitmix64(splitmix64(seed) ^ count) ^ leaf)

    over unsigned 64-bit integers, so it depends only on the transform's
    seed, the replicated step count and the leaf's position in the
    flatten order. Every rank therefore derives the same generator for the
    same (step, leaf), which is what codecs with a shared random selection
    rely on. The bits differ from JAX's threefry stream: tests that compare
    a random codec with the JAX package feed both the same noise.

    :meth:`fold` is the counterpart of a further ``jax.random.fold_in(key,
    i)`` (a ring's per-shard and per-hop keys): each folded ``i`` adds one
    more step, ``s = splitmix64(s ^ i)``, after the three above.
    :meth:`seed_int32` is the counterpart of ``jax.random.randint(key, (),
    0, 2**31 - 1, int32)``: a host-side seed for the kernels' counter hash.
    """

    seed: int
    count: int
    leaf: int
    folds: Tuple[int, ...] = ()

    def derived_seed(self) -> int:
        s = _splitmix64(self.seed & _MASK64)
        s = _splitmix64(s ^ (self.count & _MASK64))
        s = _splitmix64(s ^ (self.leaf & _MASK64))
        for i in self.folds:
            s = _splitmix64(s ^ (i & _MASK64))
        return s

    def fold(self, i: int) -> "LeafKey":
        """The key of sub-stream ``i`` (``jax.random.fold_in(key, i)``)."""
        return dataclasses.replace(self, folds=self.folds + (int(i),))

    def seed_int32(self) -> int:
        """A seed in ``[0, 2**31 - 1)``, drawn on the host from this key."""
        return self.derived_seed() % (2**31 - 1)

    def generator(self, device) -> torch.Generator:
        """A fresh generator on ``device`` seeded by the contract above."""
        gen = torch.Generator(device=device)
        gen.manual_seed(self.derived_seed())
        return gen

    def uniform(self, shape, device) -> torch.Tensor:
        """Float32 uniforms in ``[0, 1)`` from this key's stream: the one
        place the staged stochastic codecs draw their noise (the
        counterpart of ``jax.random.uniform(key, shape)``)."""
        return torch.rand(shape, generator=self.generator(device),
                          device=device, dtype=torch.float32)


# -- the three roles ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Compressor:
    """Lossy gradient codec.

    Capability flags, as in the JAX package:

    * ``average`` — divide the aggregate by the world size.
    * ``vote_aggregate`` — ``aggregate`` is a majority vote over ±1 tensors.
    * ``payload_algebra`` — how payloads compose under cross-rank addition:
      ``"exact"`` (linear float payloads), ``"shared_scale"`` (integer
      levels under one negotiated scale), ``"sketch"`` (mergeable
      sketches) or None (they do not compose). ``summable_payload``
      derives from it and gates :class:`~grace_tpu_torch.comm.Allreduce`.
    * ``supports_hop_requant`` — re-running ``compress`` on a partial sum
      of decompressed tensors is a sound re-encoding (ring schedules).
    * ``negotiates`` — the codec runs a pre-encode collective.
    """

    average = True
    vote_aggregate = False
    payload_algebra = None
    supports_hop_requant = False
    negotiates = False

    @property
    def summable_payload(self) -> bool:
        return self.payload_algebra is not None

    def init_state(self, x: torch.Tensor) -> State:
        return None

    # -- pre-encode negotiation (shared scale) --------------------------------

    def negotiate(self, x: torch.Tensor, group, rng: LeafKey = None):
        """The pre-encode collective over ``group``: return the value every
        rank holds alike (a shared scale) that ``compress(..., shared=...)``
        encodes against, or None when the codec needs none. The
        communicators run it before the stage-1 encode, so error feedback
        covers the one negotiated encode."""
        return None

    def negotiation_nbytes(self, world: int) -> int:
        """Bytes one rank receives in one :meth:`negotiate` at ``world``
        ranks; 0 for codecs without a negotiation."""
        return 0

    def payload_sum_max_world(self) -> Optional[int]:
        """Largest world whose payload-space sum stays exact in the payload
        dtype, or None for no codec-specific bound. The homomorphic paths
        of the communicators raise beyond it."""
        return None

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey,
                 shared=None) -> tuple[Payload, Ctx, State]:
        """Encode ``x``; return (wire payload, decode ctx, next state).
        ``shared`` is the result of :meth:`negotiate`, passed only by the
        codecs that negotiate."""
        raise NotImplementedError

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        """Decode one rank's payload back to a dense tensor."""
        raise NotImplementedError

    def aggregate(self, stacked: torch.Tensor) -> torch.Tensor:
        """Reduce decompressed tensors stacked along a leading world axis."""
        return torch.sum(stacked, dim=0)

    # -- the wire path's hooks: the communicators' hop arithmetic runs
    # through these, so a codec can swap in its fused kernels without the
    # schedules knowing. The defaults are the staged spellings.

    def decode_accumulate(self, payloads: Sequence[Payload],
                          ctxs: Sequence[Ctx]) -> torch.Tensor:
        """Decode K payloads and sum them into one dense partial, left to
        right (the ring hop's ``decompress(recv) + decompress(own)``).
        Codecs with a fused decode→accumulate kernel override this."""
        out = self.decompress(payloads[0], ctxs[0])
        for payload, ctx in zip(payloads[1:], ctxs[1:]):
            out = out + self.decompress(payload, ctx)
        return out

    def payload_add(self, a: Payload, b: Payload) -> Payload:
        """Payload-space ``a + b`` for summable payloads (the exact ring
        hop): element-wise over the tuple."""
        return tuple(r + o for r, o in zip(a, b))

    def payload_sum(self, stacked: Payload) -> Payload:
        """Payload-space sum over a stacked leading world axis (the
        reduce-scatter's owned-chunk sum), in the payload's own dtype:
        ``torch.sum`` would widen int16 to int64, and the accumulator
        width is what :meth:`payload_sum_max_world` bounds."""
        return tuple(torch.sum(t, dim=0, dtype=t.dtype) for t in stacked)

    def wire_fused(self) -> bool:
        """True when :meth:`decode_accumulate` runs a fused kernel. Default
        False (no wire kernels)."""
        return False


@dataclasses.dataclass(frozen=True)
class Memory:
    """Error-feedback memory: ``compensate`` folds the state into the
    gradient, ``update`` stores the new state after compression."""

    def init_state(self, x: torch.Tensor) -> State:
        return None

    def compensate(self, x: torch.Tensor, state: State
                   ) -> tuple[torch.Tensor, State]:
        return x, state

    def update(self, compensated: torch.Tensor, payload: Payload, ctx: Ctx,
               compressor: Compressor, state: State) -> State:
        return state


@dataclasses.dataclass(frozen=True)
class Communicator:
    """Collective exchange of compressed payloads over a process group."""

    group: Optional[Any] = None     # torch.distributed group; None = default

    def world_size(self) -> int:
        return dist.get_world_size(self.group)

    def shard_spec(self, n: int) -> tuple[int, int, int]:
        """Equal-shard split of an ``n``-element flat buffer over the group:
        ``(world, shard_elems, pad)`` with ``world * shard_elems == n +
        pad``, the chunk schedule of the shard-parallel communicators."""
        w = self.world_size()
        pad = (-n) % w
        return w, (n + pad) // w, pad

    def exchange(self, payload: Payload, ctx: Ctx, compressor: Compressor
                 ) -> torch.Tensor:
        """Exchange payloads across ranks; return the aggregated tensor."""
        raise NotImplementedError

    def step_leaves(self, xs: Sequence[torch.Tensor],
                    mem_states: Sequence[State], comp_states: Sequence[State],
                    memory: Memory, compressor: Compressor,
                    rngs: Sequence[LeafKey]
                    ) -> tuple[list, list, list]:
        """``fusion=None``'s per-leaf pipelines over every leaf at once:
        ``(outs, mem_states, comp_states)`` in leaf order. The default runs
        :meth:`step` leaf by leaf; a communicator may group leaves whose
        results stay the same bit for bit."""
        outs, mems, comps = [], [], []
        for x, ms, cs, rng in zip(xs, mem_states, comp_states, rngs):
            out, ms, cs = self.step(x, ms, cs, memory, compressor, rng)
            outs.append(out)
            mems.append(ms)
            comps.append(cs)
        return outs, mems, comps

    def step(self, x: torch.Tensor, mem_state: State, comp_state: State,
             memory: Memory, compressor: Compressor, rng: LeafKey
             ) -> tuple[torch.Tensor, State, State]:
        """compensate → compress → memory update → exchange.

        Fused fast path: when the memory declares linear error feedback
        (``linear_feedback_coeffs``: compensate = β·state + γ·x, update =
        compensated − decompress) and the compressor offers
        ``fused_feedback_compress`` (chunk Top-K's one-pass kernel), the
        three local stages become one call with the same result bit for
        bit. The compressor returns None where its gates send the leaf
        down the staged path.
        """
        coeffs = getattr(memory, "linear_feedback_coeffs", None)
        fused = getattr(compressor, "fused_feedback_compress", None)
        if coeffs is not None and fused is not None and mem_state is not None:
            fused_out = fused(x, mem_state, coeffs, rng)
            if fused_out is not None:
                payload, ctx, mem_state = fused_out
                return (self.exchange(payload, ctx, compressor), mem_state,
                        comp_state)
        compensated, mem_state = memory.compensate(x, mem_state)
        # The negotiation runs before the encode, on the compensated
        # tensor: the shared value (and so the decode ctx) is the same on
        # every rank, payloads sum homomorphically, and error feedback
        # covers the one negotiated encode. A process group always exists
        # here, a one-rank one included, so it always runs.
        shared = None
        if needs_negotiation(compressor):
            shared = compressor.negotiate(compensated, self.group, rng=rng)
        if shared is None:
            payload, ctx, comp_state = compressor.compress(
                compensated, comp_state, rng)
        else:
            payload, ctx, comp_state = compressor.compress(
                compensated, comp_state, rng, shared=shared)
        mem_state = memory.update(compensated, payload, ctx, compressor,
                                  mem_state)
        return self.exchange(payload, ctx, compressor), mem_state, comp_state
