"""Deterministic, seedable fault injectors; counterpart of the JAX
package's ``resilience/chaos.py``.

The faults are :class:`~grace_tpu_torch.core.Compressor` and
:class:`~grace_tpu_torch.core.Communicator` wrappers, so they slot into any
pipeline (``grace_from_params`` triads, guarded chains, bare
``Communicator.step`` calls) without touching the code under test, and a
host-side injector for state at rest:

* **NaN/Inf implants**: one random element of the gradient overwritten,
  with a per-(step, leaf) probability, on every rank or on one (``rank``);
* **payload bit flips**: one random bit of one element of each wire
  payload tensor (interconnect or DMA corruption);
* **stale residuals**: this step's error-feedback update dropped, so the
  memory replays the last residual;
* **drift** (``ChaosCompressor(drift_scale=...)``): the gated rank's
  float payload lanes (and a shared-scale codec's integer levels) scaled by
  ``1 - drift_scale`` every step, a degrading encoder: finite, so the guard
  is blind to it, and per rank, so the consensus audit is too; it moves
  that rank's compression error and residual norm away from the fleet,
  which the watch ring (:mod:`grace_tpu_torch.telemetry.aggregate`) flags;
* **single-rank silent corruption** (:class:`ChaosParams`): between steps,
  one bit of one element of a replicated tensor flipped in one rank's copy
  only, the fault the consensus audit exists to catch.

Every draw hangs off the :class:`~grace_tpu_torch.core.LeafKey` the
transform hands the pipeline, folded with ``seed``: the same run with the
same seeds makes the same faults. The bits are the port's streams, not the
JAX package's threefry draws (``ChaosParams`` draws from numpy, as JAX's
does, and picks the same leaf, element and bit). ``rank`` gating is the
host's ``dist.get_rank(group) == rank``.

The wrappers do not forward the fused-kernel hooks
(``fused_feedback_compress[_leaves]``, ``fused_aggregate_decompress
[_leaves]``, ``fused_roundtrip_leaves``): a fused path would skip the
injection points and turn the chaos run into a clean one. A pipeline with a
``ChaosCompressor`` therefore runs the staged path and launches no chunk
Top-K kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from grace_tpu_torch.core import (Communicator, Compressor, Ctx, LeafKey,
                                  Memory, Payload, State,
                                  negotiation_bytes_for)

__all__ = ["ChaosCompressor", "ChaosCommunicator", "ChaosParams"]

_INTS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _gate(rank: Optional[int], group) -> bool:
    """True on the faulted rank (every rank when ``rank`` is None)."""
    if rank is None:
        return True
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group) == rank
    return rank == 0


def _hit(key: LeafKey, prob: float, device) -> torch.Tensor:
    """A device bool drawn true with probability ``prob``."""
    return key.uniform((), device) < prob


def _implant(x: torch.Tensor, key: LeafKey, value: float) -> torch.Tensor:
    """``x`` with one random element overwritten by ``value``."""
    if x.numel() == 0:
        return x
    pos = key.randint((1,), 0, x.numel(), x.device).long()
    return x.reshape(-1).clone().index_fill_(0, pos, value).reshape(x.shape)


def _bit_mask(bit: int, dtype: torch.dtype) -> int:
    """``1 << bit`` as a value of the integer ``dtype`` (two's complement
    for the signed ones)."""
    mask, bits = 1 << bit, torch.iinfo(dtype).bits
    if dtype.is_signed and mask >= 1 << (bits - 1):
        mask -= 1 << bits
    return mask


def _flip_one_bit(t: torch.Tensor, key: LeafKey) -> torch.Tensor:
    """``t`` with one random bit of one random element flipped."""
    if t.numel() == 0 or t.dtype == torch.bool:
        return t
    kpos, kbit = key.split(2)
    pos = kpos.randint((1,), 0, t.numel(), t.device).long()
    bit = kbit.randint((1,), 0, t.element_size() * 8, t.device)
    ints = t.reshape(-1).view(_INTS[t.element_size()]).clone()
    mask = torch.bitwise_left_shift(torch.ones_like(bit, dtype=ints.dtype),
                                    bit.to(ints.dtype))
    ints.scatter_(0, pos, ints.gather(0, pos) ^ mask)
    return ints.view(t.dtype).reshape(t.shape)


def _map_state(fn, *states):
    """``fn`` over the tensors of equally structured memory states (None,
    a tensor, or dicts, lists and tuples of them)."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return fn(*states)
    if isinstance(first, dict):
        return {k: _map_state(fn, *(s[k] for s in states)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map_state(fn, *parts)
                           for parts in zip(*states))
    return first


@dataclasses.dataclass(frozen=True)
class ChaosCompressor(Compressor):
    """Fault-injecting wrapper around any compressor.

    ``nan_prob``/``inf_prob`` implant into the input before the inner codec
    sees it (a poisoned gradient); ``bitflip_prob`` corrupts each payload
    tensor after encoding (wire corruption); ``drift_scale`` attenuates the
    gated rank's value lanes every step (module docstring). Probabilities
    are per (step, leaf): the key ``compress`` receives is already the
    step's and the leaf's, and ``seed`` keeps the faults apart from the
    codec's own randomness. ``group`` is the process group ``rank`` counts
    in."""

    inner: Compressor
    nan_prob: float = 0.0
    inf_prob: float = 0.0
    bitflip_prob: float = 0.0
    drift_scale: float = 0.0
    rank: Optional[int] = None
    group: Optional[Any] = None
    seed: int = 0

    # -- the inner codec's contract, delegated --------------------------------
    @property
    def average(self):  # type: ignore[override]
        return self.inner.average

    @property
    def tensors_size_are_same(self):  # type: ignore[override]
        return self.inner.tensors_size_are_same

    @property
    def vote_aggregate(self):  # type: ignore[override]
        return self.inner.vote_aggregate

    @property
    def payload_algebra(self):  # type: ignore[override]
        # The injector rides whatever accumulation path the inner codec
        # qualifies for; faults then land in the summed payload, as a
        # corrupting wire or a degrading encoder would.
        return self.inner.payload_algebra

    @property
    def supports_hop_requant(self):  # type: ignore[override]
        return self.inner.supports_hop_requant

    @property
    def negotiates(self):  # type: ignore[override]
        return getattr(self.inner, "negotiates", False)

    @property
    def packed_fields(self):
        return getattr(self.inner, "packed_fields", False)

    def init_state(self, x: torch.Tensor) -> State:
        return self.inner.init_state(x)

    def wire_nbytes(self, shape, dtype):
        return self.inner.wire_nbytes(shape, dtype)

    def negotiate(self, x: torch.Tensor, group, rng: LeafKey = None):
        return self.inner.negotiate(x, group, rng=rng)

    def negotiation_nbytes(self, world: int) -> int:
        return self.inner.negotiation_nbytes(world)

    def negotiation_nbytes_for(self, n_elems: int, world: int) -> int:
        return negotiation_bytes_for(self.inner, n_elems, world)

    def payload_sum_max_world(self):
        return self.inner.payload_sum_max_world()

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        return self.inner.decompress(payload, ctx)

    def aggregate(self, stacked: torch.Tensor) -> torch.Tensor:
        return self.inner.aggregate(stacked)

    # The wire path's hooks run on received payloads, downstream of every
    # injection point, so forwarding them skips no fault; a packed codec
    # needs its own accumulate spelling.
    def payload_add(self, a: Payload, b: Payload) -> Payload:
        return self.inner.payload_add(a, b)

    def payload_sum(self, stacked: Payload) -> Payload:
        return self.inner.payload_sum(stacked)

    def decode_accumulate(self, payloads, ctxs):
        return self.inner.decode_accumulate(payloads, ctxs)

    def wire_fused(self) -> bool:
        return self.inner.wire_fused()

    # -- the faulted encode --------------------------------------------------
    def compress(self, x: torch.Tensor, state: State, rng: LeafKey,
                 shared=None) -> tuple[Payload, Ctx, State]:
        gate = _gate(self.rank, self.group)
        ckey = rng.fold(self.seed)
        for prob, value in ((self.nan_prob, float("nan")),
                            (self.inf_prob, float("inf"))):
            if prob:
                khit, kpos, ckey = ckey.split(3)
                if gate:
                    x = torch.where(_hit(khit, prob, x.device),
                                    _implant(x, kpos, value), x)
        payload, ctx, new_state = (
            self.inner.compress(x, state, rng) if shared is None
            else self.inner.compress(x, state, rng, shared=shared))
        if self.bitflip_prob:
            corrupted = []
            for t in payload:
                khit, kflip, ckey = ckey.split(3)
                if gate:
                    t = torch.where(_hit(khit, self.bitflip_prob, t.device),
                                    _flip_one_bit(t, kflip), t)
                corrupted.append(t)
            payload = tuple(corrupted)
        if self.drift_scale and gate:
            scale = 1.0 - self.drift_scale
            shared_scale = self.payload_algebra == "shared_scale"

            def attenuate(t):
                if t.is_floating_point():
                    return t * torch.tensor(scale, dtype=t.dtype)
                if shared_scale and not t.dtype.is_complex \
                        and t.dtype != torch.bool:
                    # A shared-scale codec's integer lanes are its values
                    # (levels against the negotiated scale): scaled on the
                    # quantization lattice, as JAX does.
                    return torch.round(t.to(torch.float32) * scale) \
                        .to(t.dtype)
                return t

            payload = tuple(attenuate(t) for t in payload)
        return payload, ctx, new_state


@dataclasses.dataclass(frozen=True)
class ChaosCommunicator(Communicator):
    """Fault-injecting wrapper around any communicator, at the pipeline
    level: ``nan_prob``/``inf_prob`` poison the incoming per-rank gradient
    before compensate and compress (a bad batch), ``stale_prob`` drops
    this step's memory update so the residual goes stale. The wrapped
    communicator performs the exchange unchanged, over its own group."""

    inner: Optional[Communicator] = None
    nan_prob: float = 0.0
    inf_prob: float = 0.0
    stale_prob: float = 0.0
    rank: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        if self.inner is None:
            raise TypeError("ChaosCommunicator requires inner=Communicator")
        # Rank gating and world_size() read the inner communicator's group.
        object.__setattr__(self, "group", self.inner.group)

    @property
    def shard_parallel(self):  # type: ignore[override]
        return getattr(self.inner, "shard_parallel", False)

    def _recv_total_bytes(self, payload_nbytes: int, n_elems: int,
                          world: int, vote: bool = False) -> int:
        # Injection moves no extra bytes: telemetry prices the inner
        # schedule.
        return self.inner._recv_total_bytes(payload_nbytes, n_elems, world,
                                            vote=vote)

    def recv_link_bytes(self, payload_nbytes: int, n_elems: int, world: int,
                        topology=None, vote: bool = False):
        return self.inner.recv_link_bytes(payload_nbytes, n_elems, world,
                                          topology=topology, vote=vote)

    def step(self, x: torch.Tensor, mem_state: State, comp_state: State,
             memory: Memory, compressor: Compressor, rng: LeafKey
             ) -> tuple[torch.Tensor, State, State]:
        gate = _gate(self.rank, self.group)
        ckey = rng.fold(self.seed)
        for prob, value in ((self.nan_prob, float("nan")),
                            (self.inf_prob, float("inf"))):
            if prob:
                khit, kpos, ckey = ckey.split(3)
                if gate:
                    x = torch.where(_hit(khit, prob, x.device),
                                    _implant(x, kpos, value), x)
        # The kernels may write the residual in place: keep the old one.
        old = (_map_state(torch.clone, mem_state)
               if self.stale_prob and gate else None)
        out, new_mem, new_comp = self.inner.step(
            x, mem_state, comp_state, memory, compressor, rng)
        if self.stale_prob:
            khit, ckey = ckey.split(2)
            if gate:
                stale = _hit(khit, self.stale_prob, x.device)
                new_mem = _map_state(
                    lambda o, n: torch.where(stale, o, n), old, new_mem)
        return out, new_mem, new_comp

    def step_rows(self, xs, mem_states, comp_states, memory, compressor,
                  rngs):
        # Row by row through step, so every row meets the injectors (the
        # rows' results are the ones step gives, by step_rows' contract).
        outs, mems, comps = [], [], []
        for x, ms, cs, rng in zip(xs, mem_states, comp_states, rngs):
            out, ms, cs = self.step(x, ms, cs, memory, compressor, rng)
            outs.append(out)
            mems.append(ms)
            comps.append(cs)
        return outs, mems, comps

    def exchange(self, payload: Payload, ctx: Ctx, compressor: Compressor
                 ) -> torch.Tensor:
        return self.inner.exchange(payload, ctx, compressor)


@dataclasses.dataclass
class ChaosParams:
    """Host-side single-rank silent corruption of replicated state::

        chaos = ChaosParams(rank=3, at_steps=(10,), seed=7)
        for i, batch in enumerate(batches):
            state = chaos(state, i)        # maybe corrupt BEFORE the step
            state, loss = step(state, batch)

    On a hit step (``at_steps``, or with probability ``prob``) it picks one
    floating leaf of ``target``, one element and one bit, all drawn from
    ``numpy.random.default_rng((seed << 20) ^ step)`` as the JAX package
    draws them, and flips that bit in rank ``rank``'s copy only, in place
    (the other ranks keep theirs). ``target``: ``"params"`` (the model's
    parameters in the JAX flatten order, ``transform.leaf_order``: the
    leaf JAX picks), ``"model"`` (its ``state_dict``), ``"optimizer"``
    (the optimizer's tensor state) or None (the model's ``state_dict``
    then the optimizer's). ``state`` is a ``train.TrainState``. Every
    injection, on every rank, is appended to :attr:`injections` as
    ``(step, leaf_index, element, bit)``."""

    rank: int = 0
    at_steps: tuple = ()
    prob: float = 0.0
    seed: int = 0
    target: Optional[str] = "params"
    group: Optional[Any] = None

    def __post_init__(self):
        if self.target not in ("params", "model", "optimizer", None):
            raise ValueError(f"ChaosParams target must be 'params', "
                             f"'model', 'optimizer' or None; got "
                             f"{self.target!r}")
        self.injections: list = []

    def _hit(self, step: int, rng) -> bool:
        if step in tuple(self.at_steps):
            return True
        return bool(self.prob) and rng.random() < self.prob

    def _leaves(self, state) -> list:
        from grace_tpu_torch.transform import leaf_order
        leaves = []
        if self.target == "params":
            named = dict(state.model.named_parameters())
            return [named[n] for n in leaf_order(named)]
        if self.target in ("model", None):
            leaves += list(state.model.state_dict().values())
        if self.target in ("optimizer", None):
            opt = state.optimizer
            for group in opt.param_groups:
                for p in group["params"]:
                    st = opt.state.get(p, {})
                    leaves += [st[k] for k in sorted(st)
                               if torch.is_tensor(st[k])]
        return leaves

    def __call__(self, state, step: int):
        rng = np.random.default_rng((self.seed << 20) ^ step)
        if not self._hit(step, rng):
            return state
        leaves = self._leaves(state)
        float_idx = [i for i, t in enumerate(leaves)
                     if t.is_floating_point() and t.numel() > 0]
        if not float_idx:
            return state
        world = (dist.get_world_size(self.group)
                 if dist.is_available() and dist.is_initialized() else 1)
        if self.rank >= world:
            raise ValueError(
                f"ChaosParams(rank={self.rank}) but the group has only "
                f"{world} ranks — the corruption needs a replicated leaf "
                "with one copy a rank.")
        li = int(rng.choice(float_idx))
        arr = leaves[li]
        pos = int(rng.integers(arr.numel()))
        bit = int(rng.integers(arr.element_size() * 8))
        if _gate(self.rank, self.group):
            ints = _INTS[arr.element_size()]
            with torch.no_grad():       # in place, on the device
                flat = arr.detach().view(-1).view(ints)
                flat[pos].bitwise_xor_(_bit_mask(bit, ints))
        self.injections.append((step, li, pos, bit))
        return state
