"""Communicators over ``torch.distributed``; counterpart of the JAX
``comm/__init__.py`` (``Allreduce`` with its majority-vote routing and its
homomorphic path, ``Allgather``, ``Broadcast``, ``SignAllreduce``,
``TwoShotAllreduce``, ``RingAllreduce``, ``ReduceScatterAllreduce``,
``HierarchicalAllreduce`` and ``Identity``), each with its wire-byte model
(``recv_link_bytes``, ``recv_wire_bytes``, ``wire_overlap_fraction``).

NCCL carries them on the card, gloo in the CPU tests. A world of one rank
still makes the real collective calls, except the ring's point-to-point
hops, of which a one-rank ring has none.

:func:`masked_broadcast` (and its in-place and tree forms) is the
consensus repair's bit-exact broadcast: a masked SUM in integer bit space.

Neither NCCL nor gloo carries 16-bit integers. So the collectives that
only move data (the gathers, the all-to-all and the ring's point-to-point
hops) move integer and bool payloads as their bytes, and the
``Allreduce`` sum of int8/int16 levels runs as an int32 all-reduce,
narrowed back afterwards: exact under ``payload_sum_max_world``, and a
wrap beyond it as a 16-bit add would wrap. Float payloads ride as they
are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from grace_tpu_torch.core import (SINGLE_SLICE, Communicator, Compressor,
                                  Ctx, LeafKey, LinkBytes, Memory, Payload,
                                  Topology, mean_scale)
from grace_tpu_torch.telemetry import counters
from grace_tpu_torch.telemetry.scopes import (STAGE_COMPRESS,
                                              STAGE_DECOMPRESS,
                                              STAGE_EXCHANGE, STAGE_PIPELINE,
                                              STAGE_RING_HOP, trace_stage)

__all__ = ["Allreduce", "Allgather", "Broadcast", "Identity",
           "SignAllreduce", "TwoShotAllreduce", "RingAllreduce",
           "ReduceScatterAllreduce", "HierarchicalAllreduce",
           "WIRE_PIPELINE_EFFICIENCY", "vote_exact_max_world",
           "masked_broadcast", "masked_broadcast_tree", "masked_broadcast_"]

# Newer PyTorch renames all_gather_into_tensor (same signature) and
# deprecates the old name.
_all_gather_into = (getattr(dist, "all_gather_single", None)
                    or dist.all_gather_into_tensor)

_HOMOMORPHIC = ("shared_scale", "sketch")

# Share of a pipelined segment's wire time credited as hidden behind the
# neighbouring segment's compute: half of the steady-state (P-1)/P overlap
# of a double buffer, until a measured trace replaces it. The pipelined
# ring and hier schedules' ``wire_overlap_fraction`` read it.
WIRE_PIPELINE_EFFICIENCY = 0.5


def _ring_bytes(payload_nbytes: int, world: int) -> int:
    """``2·payload·(W−1)/W``: a reduce-scatter plus an all-gather of
    ~payload/W shards, the bytes of every ring-family schedule. ``W−1`` is
    clamped at 0, so a degenerate world of 0 or 1 ranks prices to 0."""
    return 2 * payload_nbytes * max(0, world - 1) // max(1, world)


def _pipelined_overlap(pipeline: int) -> float:
    if pipeline <= 1:
        return 0.0
    return WIRE_PIPELINE_EFFICIENCY * (pipeline - 1) / pipeline


def _algebra(compressor) -> str | None:
    return getattr(compressor, "payload_algebra", None)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous 1-D buffer for a collective that only moves
    data: its bytes (uint8) for integer and bool tensors, itself for
    floats. ``buf.view(t.dtype).view(t.shape)`` undoes it."""
    t = t.contiguous().reshape(-1)
    return t if t.is_floating_point() else t.view(torch.uint8)


def _all_reduce_sum(t: torch.Tensor, group) -> None:
    """Sum ``t`` across ``group`` in place; int8/int16 through int32."""
    if t.dtype in (torch.int8, torch.int16):
        wide = t.to(torch.int32)
        counters.count("all_reduce", wide)
        dist.all_reduce(wide, op=dist.ReduceOp.SUM, group=group)
        t.copy_(wide)
    else:
        counters.count("all_reduce", t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)


# The integer view a masked broadcast sums, by element width: the widths
# NCCL and gloo add exactly; 16-bit values (and bools) go as their bytes.
_MB_INT = {1: torch.uint8, 2: torch.uint8, 4: torch.int32, 8: torch.int64}


def _group_rank_world(group) -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def masked_broadcast_(tensors, root: int, group=None) -> None:
    """Overwrite every tensor of ``tensors`` with rank ``root``'s value, bit
    for bit, in place: each rank views its tensor as integers, zeroes the
    view unless it is ``root``, and all-reduces with SUM (the JAX package's
    ``axis_index``-masked psum in integer bit space). Only ``root`` adds a
    non-zero word, so the integer sum is ``root``'s bits exactly: ``-0.0``,
    NaN payloads, integers and bools survive, where a float sum would turn
    ``-0.0 + 0.0`` into ``+0.0``. ``root`` is a rank of ``group``; every
    rank of it calls this with the same tensors' shapes. One all-reduce a
    tensor, and no value is read back to the host."""
    rank, world = _group_rank_world(group)
    for t in tensors:
        if t.numel() == 0:
            continue
        work = t if t.is_contiguous() else t.contiguous()
        bits = work.reshape(-1).view(_MB_INT[work.element_size()])
        if rank != root:
            bits.zero_()
        if world > 1:
            counters.count("all_reduce", bits)
            dist.all_reduce(bits, op=dist.ReduceOp.SUM, group=group)
        if work is not t:
            t.copy_(work)


def masked_broadcast(x: torch.Tensor, root: int, group=None
                     ) -> torch.Tensor:
    """Rank ``root``'s ``x`` on every rank of ``group``, bit for bit, as a
    new tensor (:func:`masked_broadcast_`)."""
    out = torch.as_tensor(x).clone(memory_format=torch.contiguous_format)
    masked_broadcast_([out], root, group)
    return out


def masked_broadcast_tree(tree, root: int, group=None):
    """:func:`masked_broadcast` over every tensor of a tree of dicts, lists
    and tuples; other leaves come back as they are."""
    if isinstance(tree, torch.Tensor):
        return masked_broadcast(tree, root, group)
    if isinstance(tree, dict):
        return {k: masked_broadcast_tree(v, root, group)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(masked_broadcast_tree(v, root, group)
                            for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(masked_broadcast_tree(v, root, group)
                          for v in tree)
    return tree


def _check_payload_sum_world(compressor: Compressor, world: int,
                             schedule: str) -> None:
    """The shared-scale overflow gate: a payload-space sum over ``world``
    ranks must stay exact in the payload dtype, up to the codec's own
    ``payload_sum_max_world``."""
    bound = compressor.payload_sum_max_world()
    if bound is not None and world > bound:
        raise ValueError(
            f"{schedule} sums {type(compressor).__name__} payloads across "
            f"{world} ranks but the payload dtype carries exact sums only "
            f"up to world {bound} (payload_sum_max_world: accumulator "
            "iinfo.max // max level) — widen accum_dtype or lower "
            "quantum_num; the numeric_safety pass rejects this statically "
            "from the same constant.")


def _torch_dtype(name) -> torch.dtype:
    dt = getattr(torch, name) if isinstance(name, str) else name
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"unknown dtype {name!r}")
    return dt


def vote_exact_max_world(vote_dtype) -> int:
    """Largest world size whose ±1 majority-vote sums stay integer-exact
    in ``vote_dtype``: a float with p explicit mantissa bits holds every
    integer up to ``2^(p+1)``, and a W-rank tally lies in ``[-W, W]``.
    bfloat16 gives 256, float16 2048, float32 16,777,216."""
    dt = _torch_dtype(vote_dtype)
    if not dt.is_floating_point:
        raise TypeError(f"vote_dtype must be a float dtype; got {dt}")
    nmant = round(-math.log2(torch.finfo(dt).eps))
    return 2 ** (nmant + 1)


def _psum_majority_vote(dec: torch.Tensor, group,
                        vote_dtype: str) -> torch.Tensor:
    """All-reduce this rank's decoded ±1 signs and re-sign: the exact
    majority vote at a collective cost that does not grow with the world.
    Shared by SignAllreduce and the Allreduce vote routing, per leaf and
    over a grouped payload's concatenated decode (±1 tallies below
    ``vote_exact_max_world`` are exact in any summation order, so the two
    agree bit for bit)."""
    w = dist.get_world_size(group)
    bound = vote_exact_max_world(vote_dtype)
    if w > bound:
        raise ValueError(
            f"vote_dtype={vote_dtype!r} is integer-exact only up to world "
            f"size {bound} (comm.vote_exact_max_world: 2^(mantissa+1)); "
            f"this group has {w}: use vote_dtype='float32'.")
    vdt = _torch_dtype(vote_dtype)
    summed = dec.to(vdt, copy=True)
    with trace_stage(f"{STAGE_EXCHANGE}/psum_vote"):
        counters.count("all_reduce", summed)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    out = (summed >= 0).to(vdt) * 2 - 1
    return out.to(dec.dtype)


def _is_identity_memory(memory) -> bool:
    """A memory whose compensate and update are the base no-ops (none)."""
    return (type(memory).compensate is Memory.compensate
            and type(memory).update is Memory.update)


def _vote_step_leaves(comm: Communicator, xs, mem_states, comp_states,
                      memory, compressor, rngs, vote_dtype: str,
                      fallback=Communicator.step_leaves):
    """``step_leaves`` (and ``step_rows``) of the all-reduce vote: the
    leaves that the codec's grouped compress takes (signsgd under linear
    error feedback or no memory) go through one grouped sign-pack, one
    decode of the concatenated payload, one all-reduce and one re-sign; the
    other leaves run ``comm.step``. Bit-identical to ``step`` leaf by leaf.
    When the codec takes no leaf, ``fallback`` runs them all."""
    compress = getattr(compressor, "fused_feedback_compress_leaves", None)
    coeffs = getattr(memory, "linear_feedback_coeffs", None)
    grouped = None
    if (getattr(compressor, "vote_aggregate", False) and compress is not None
            and (coeffs is not None or _is_identity_memory(memory))):
        with trace_stage(STAGE_COMPRESS):
            grouped = compress(xs, mem_states, coeffs, rngs)
    if grouped is None:
        return fallback(comm, xs, mem_states, comp_states, memory,
                        compressor, rngs)
    taken, payload, ctx, new_mem = grouped
    # Every rank takes the same leaves (the gates read shapes and dtypes
    # only), so the collectives line up.
    with trace_stage(STAGE_DECOMPRESS):
        dec = compressor.decompress_leaves(payload, ctx)
        views = compressor.leaf_views(dec, ctx)
        sizes = [v.numel() for v in views]
        if sum(sizes) != dec.numel():
            # The tally moves the leaves' elements only: the decode's
            # padding lanes (up to 127 a leaf) are not on the wire model.
            dec = torch.cat([v.reshape(-1) for v in views])
    with trace_stage(STAGE_EXCHANGE):
        voted = _psum_majority_vote(dec, comm.group, vote_dtype)
    outs = [t.view(v.shape) for t, v in zip(torch.split(voted, sizes),
                                             views)]
    return _merge_leaves(comm, xs, mem_states, comp_states, memory,
                         compressor, rngs, taken, outs, new_mem)


def _merge_leaves(comm: Communicator, xs, mem_states, comp_states, memory,
                  compressor, rngs, taken, taken_outs, taken_mems):
    """``step_leaves``'s results in leaf order: the grouped leaves
    ``taken`` with their outputs and new memory states, and ``comm.step``
    run on every other leaf."""
    outs = [None] * len(xs)
    mems, comps = list(mem_states), list(comp_states)
    for i, out, ms in zip(taken, taken_outs, taken_mems):
        outs[i], mems[i] = out, ms
    grouped_leaves = set(taken)
    for i in range(len(xs)):
        if i not in grouped_leaves:
            outs[i], mems[i], comps[i] = comm.step(
                xs[i], mem_states[i], comp_states[i], memory, compressor,
                rngs[i])
    return outs, mems, comps


def _gather(payload: Payload, group) -> Payload:
    """All-gather every tensor of this rank's payload into a ``(W, ...)``
    stack. Gathers into a flat buffer: gloo accepts no other shape, NCCL
    both."""
    world = dist.get_world_size(group)
    gathered = []
    with trace_stage(STAGE_EXCHANGE):
        for t in payload:
            buf = _wire(t)
            out = torch.empty(world * buf.numel(), dtype=buf.dtype,
                              device=buf.device)
            counters.count("all_gather", buf)
            _all_gather_into(out, buf, group=group)
            gathered.append(out.view(t.dtype).view((world,)
                                                   + tuple(t.shape)))
    return tuple(gathered)


def _all_to_all(stacked: Payload, group) -> Payload:
    """The reduce-scatter's data movement: every ``(W, ...)`` stack of
    per-chunk payloads goes through one ``all_to_all_single``, after which
    row ``j`` holds rank ``j``'s payload for this rank's chunk."""
    out = []
    with trace_stage(STAGE_EXCHANGE):
        for s in stacked:
            buf = _wire(s)
            recv = torch.empty_like(buf)
            counters.count("all_to_all", buf)
            dist.all_to_all_single(recv, buf, group=group)
            out.append(recv.view(s.dtype).view(s.shape))
    return tuple(out)


def _rank_payload(gathered: Payload, j: int) -> Payload:
    return tuple(t[j] for t in gathered)


def _stack_rows(payloads) -> Optional[Payload]:
    """G rows' payloads stacked tensor by tensor along a new leading axis,
    or None where a row has no tensor (PowerSGD) or the rows' tensors
    differ in shape or dtype."""
    first = payloads[0]
    if not first or any(
            len(p) != len(first) or any(
                t.shape != f.shape or t.dtype != f.dtype
                for t, f in zip(p, first))
            for p in payloads):
        return None
    return tuple(torch.stack([p[i] for p in payloads])
                 for i in range(len(first)))


def _vote_rows(comm: Communicator, payloads, ctxs, compressor, vote_dtype):
    """The vote of G rows: each row decoded to ±1, one all-reduce of the
    stack, one re-sign."""
    dec = torch.stack([compressor.decompress(p, c)
                       for p, c in zip(payloads, ctxs)])
    return list(_psum_majority_vote(dec, comm.group, vote_dtype).unbind(0))


@dataclasses.dataclass(frozen=True)
class Allreduce(Communicator):
    """Sum payloads across ranks, divide by the world size if
    ``compressor.average``, then decompress once. Only for payloads that
    sum meaningfully (``summable_payload``).

    The sum is taken IN PLACE in the payload tensors: for the identity
    codec that is the gradient buffer itself, which the exchange consumes.

    Majority-vote codecs (``vote_aggregate``: signsgd, signum) are routed
    through the all-reduce vote of :class:`SignAllreduce`: summing their
    packed sign bytes would be garbage.

    Homomorphic payloads (``shared_scale``: homoqsgd; ``sketch``:
    countsketch) sum as integer levels or tables up to the codec's
    ``payload_sum_max_world``, decode once, and the mean scales the decoded
    tensor. Packed shared-scale levels (several fields a byte) raise at
    more than one rank: a byte-wise sum carries from one field into the
    next. The JAX package sums those bytes anyway and returns a wrong
    result there; the ring and the reduce-scatter sum them field by field.
    """

    vote_dtype: str = "bfloat16"

    def _recv_total_bytes(self, payload_nbytes: int, n_elems: int,
                          world: int, vote: bool = False) -> int:
        if vote:
            # An all-reduce of dense bfloat16 (2-byte) votes.
            return _ring_bytes(2 * n_elems, world)
        return _ring_bytes(payload_nbytes, world)

    def step_leaves(self, xs, mem_states, comp_states, memory, compressor,
                    rngs):
        """The vote routing groups leaves as :class:`SignAllreduce` does;
        every other codec runs :meth:`step` leaf by leaf."""
        return _vote_step_leaves(self, xs, mem_states, comp_states, memory,
                                 compressor, rngs, self.vote_dtype)

    def step_rows(self, xs, mem_states, comp_states, memory, compressor,
                  rngs):
        return _vote_step_leaves(self, xs, mem_states, comp_states, memory,
                                 compressor, rngs, self.vote_dtype,
                                 fallback=Communicator.step_rows)

    def exchange_rows(self, payloads, ctxs, compressor):
        """One all-reduce a payload tensor for G rows (one for the vote);
        each row then decodes as :meth:`exchange` decodes it."""
        if getattr(compressor, "vote_aggregate", False):
            return _vote_rows(self, payloads, ctxs, compressor,
                              self.vote_dtype)
        stacked = (_stack_rows(payloads)
                   if getattr(compressor, "summable_payload", False)
                   else None)
        if stacked is None:
            return super().exchange_rows(payloads, ctxs, compressor)
        self._check_summable(compressor)
        for t in stacked:
            _all_reduce_sum(t, self.group)
        return [self._decode_sum(_rank_payload(stacked, j), ctx, compressor)
                for j, ctx in enumerate(ctxs)]

    def _check_summable(self, compressor: Compressor) -> None:
        if not getattr(compressor, "summable_payload", False):
            raise TypeError(
                f"Allreduce requires a payload that sums meaningfully across "
                f"ranks; {type(compressor).__name__} does not declare "
                "summable_payload=True (its per-rank payloads decode "
                "differently, e.g. per-rank indices or norms). Use "
                "Allgather/Broadcast instead.")
        if _algebra(compressor) in _HOMOMORPHIC:
            world = self.world_size()
            _check_payload_sum_world(compressor, world, "Allreduce")
            if world > 1 and getattr(compressor, "packed_fields", False):
                raise TypeError(
                    f"Allreduce sums payload bytes element-wise, and "
                    f"{type(compressor).__name__} packs several level "
                    "fields into each byte: byte-wise sums corrupt packed "
                    "fields (a carry crosses into the next field). Use "
                    "'ring' or 'rscatter', which sum the fields in payload "
                    "space, or an unpacked accum_dtype.")

    def exchange(self, payload: Payload, ctx: Ctx, compressor: Compressor
                 ) -> torch.Tensor:
        if getattr(compressor, "vote_aggregate", False):
            return _psum_majority_vote(compressor.decompress(payload, ctx),
                                       self.group, self.vote_dtype)
        self._check_summable(compressor)
        # An empty payload (PowerSGD, which all-reduced inside compress)
        # goes straight to decompress.
        for t in payload:
            _all_reduce_sum(t, self.group)
        return self._decode_sum(tuple(payload), ctx, compressor)

    def _decode_sum(self, summed: Payload, ctx: Ctx, compressor: Compressor
                    ) -> torch.Tensor:
        """Decode the ranks' summed payload: the mean, then decompress."""
        if _algebra(compressor) in _HOMOMORPHIC:
            world = self.world_size()
            # One decode of the summed levels or tables; an integer or
            # sketch payload cannot carry the mean, so it scales the
            # decoded tensor (out / world).
            out = compressor.decompress(summed, ctx)
            if compressor.average:
                out = out * mean_scale(world)
            return out
        if compressor.average and summed:
            if not all(t.is_floating_point() for t in summed):
                raise TypeError(
                    "Allreduce with average=True requires float payloads; "
                    f"got {[t.dtype for t in summed]}. Use Allgather for "
                    "integer-coded compressors.")
            scale = mean_scale(self.world_size())    # t / world
            summed = tuple(t * scale for t in summed)
        return compressor.decompress(summed, ctx)


@dataclasses.dataclass(frozen=True)
class Allgather(Communicator):
    """Gather every rank's payload, decompress per rank, aggregate, and
    average after the aggregate. A codec with ``fused_aggregate_decompress``
    may do the decompress + aggregate + average in one kernel.

    Over many leaves (:meth:`step_leaves`), a codec with grouped fused
    hooks (chunk Top-K) under linear error feedback takes every leaf its
    gates pass through one grouped compress, one gather of each payload
    tensor and one grouped aggregate; the other leaves run :meth:`step`.
    """

    def step_leaves(self, xs, mem_states, comp_states, memory, compressor,
                    rngs, fallback=Communicator.step_leaves):
        coeffs = getattr(memory, "linear_feedback_coeffs", None)
        compress = getattr(compressor, "fused_feedback_compress_leaves", None)
        aggregate = getattr(compressor, "fused_aggregate_decompress_leaves",
                            None)
        grouped = None
        if coeffs is not None and compress is not None and aggregate is not None:
            with trace_stage(STAGE_COMPRESS):
                grouped = compress(xs, mem_states, coeffs, rngs)
        if grouped is None:
            return fallback(self, xs, mem_states, comp_states, memory,
                            compressor, rngs)
        taken, payload, ctx, new_mem = grouped
        # Concatenated payloads gather as one tensor each; every rank takes
        # the same leaves (the gates read shapes and dtypes only), so the
        # collectives line up.
        with trace_stage(STAGE_EXCHANGE):
            gathered = _gather(payload, self.group)
        with trace_stage(STAGE_DECOMPRESS):
            outs = aggregate(gathered, ctx, self.world_size())
        return _merge_leaves(self, xs, mem_states, comp_states, memory,
                             compressor, rngs, taken, outs, new_mem)

    def step_rows(self, xs, mem_states, comp_states, memory, compressor,
                  rngs):
        """A group's rows through the grouped Top-K hooks where they apply
        (one compress, one gather a payload tensor, one aggregate), else
        encoded row by row and gathered as one stack."""
        return self.step_leaves(xs, mem_states, comp_states, memory,
                                compressor, rngs,
                                fallback=Communicator.step_rows)

    def exchange_rows(self, payloads, ctxs, compressor):
        """One gather a payload tensor for G rows' stacked payloads; each
        row then aggregates as :meth:`exchange` aggregates it."""
        stacked = _stack_rows(payloads)
        if stacked is None:
            return super().exchange_rows(payloads, ctxs, compressor)
        gathered = _gather(stacked, self.group)        # (W, G, ...)
        return [self._aggregate(tuple(t[:, j].contiguous()
                                      for t in gathered), ctx, compressor)
                for j, ctx in enumerate(ctxs)]

    def exchange(self, payload: Payload, ctx: Ctx, compressor: Compressor
                 ) -> torch.Tensor:
        if not payload:
            # PowerSGD: the exchange already ran inside compress.
            return compressor.decompress(payload, ctx)
        return self._aggregate(_gather(payload, self.group), ctx, compressor)

    def _aggregate(self, gathered: Payload, ctx: Ctx, compressor: Compressor
                   ) -> torch.Tensor:
        """The W gathered payloads → this rank's averaged aggregate."""
        world = self.world_size()
        fused = getattr(compressor, "fused_aggregate_decompress", None)
        if fused is not None:
            with trace_stage(STAGE_DECOMPRESS):
                out = fused(gathered, ctx, world)
            if out is not None:        # handles aggregate + average itself
                return out
        with trace_stage(STAGE_DECOMPRESS):
            stacked = torch.stack([
                compressor.decompress(_rank_payload(gathered, i), ctx)
                for i in range(world)])
        out = compressor.aggregate(stacked)
        if compressor.average:
            out = out * mean_scale(world)             # out / world
        return out


@dataclasses.dataclass(frozen=True)
class Broadcast(Allgather):
    """The reference's broadcast communicator: W broadcasts compute exactly
    what one all-gather does, so it is the all-gather."""


@dataclasses.dataclass(frozen=True)
class Identity(Communicator):
    """No-op communicator: decompress this rank's own payload."""

    def _recv_total_bytes(self, payload_nbytes: int, n_elems: int,
                          world: int, vote: bool = False) -> int:
        return 0

    def exchange(self, payload: Payload, ctx: Ctx, compressor: Compressor
                 ) -> torch.Tensor:
        return compressor.decompress(payload, ctx)


@dataclasses.dataclass(frozen=True)
class SignAllreduce(Communicator):
    """Majority vote through an all-reduce instead of an all-gather:
    decompress this rank's payload to ±1, all-reduce the ±1 in
    ``vote_dtype``, re-sign. The same result as Allgather plus the sign
    codecs' vote ``aggregate``, at a collective cost that does not grow
    with the world. Only for ``vote_aggregate`` codecs (signsgd, signum).
    ``'bfloat16'`` is integer-exact up to 256 ranks
    (:func:`vote_exact_max_world`); pick ``'float32'`` beyond.

    Over many leaves (:meth:`step_leaves`), signsgd under linear error
    feedback or no memory takes every leaf its gates pass through one
    grouped sign-pack launch, one all-reduce of the concatenated tallies
    and one re-sign; the other leaves run :meth:`step`."""

    vote_dtype: str = "bfloat16"

    def _recv_total_bytes(self, payload_nbytes: int, n_elems: int,
                          world: int, vote: bool = False) -> int:
        return _ring_bytes(2 * n_elems, world)

    def step_leaves(self, xs, mem_states, comp_states, memory, compressor,
                    rngs):
        return _vote_step_leaves(self, xs, mem_states, comp_states, memory,
                                 compressor, rngs, self.vote_dtype)

    def step_rows(self, xs, mem_states, comp_states, memory, compressor,
                  rngs):
        return _vote_step_leaves(self, xs, mem_states, comp_states, memory,
                                 compressor, rngs, self.vote_dtype,
                                 fallback=Communicator.step_rows)

    def exchange_rows(self, payloads, ctxs, compressor):
        self._check_vote(compressor)
        return _vote_rows(self, payloads, ctxs, compressor, self.vote_dtype)

    def exchange(self, payload: Payload, ctx: Ctx, compressor: Compressor
                 ) -> torch.Tensor:
        self._check_vote(compressor)
        return _psum_majority_vote(compressor.decompress(payload, ctx),
                                   self.group, self.vote_dtype)

    @staticmethod
    def _check_vote(compressor: Compressor) -> None:
        if not getattr(compressor, "vote_aggregate", False):
            raise TypeError(
                "SignAllreduce implements majority-vote aggregation; "
                f"{type(compressor).__name__} does not declare "
                "vote_aggregate=True (its aggregate carries scaling the "
                "re-sign would drop): use Allreduce/Allgather instead.")


# -- the compressed ring -----------------------------------------------------

def _pipeline_segments(n: int, pipeline: int) -> list[tuple[int, int]]:
    """``[lo, hi)`` bounds of the ``pipeline`` contiguous segments of an
    ``n``-element flat buffer: equal ``ceil(n/P)`` segments (the last may
    be shorter), clamped so that no segment is empty."""
    p = max(1, min(int(pipeline), n if n else 1))
    per = -(-n // p)
    return [(lo, min(lo + per, n)) for lo in range(0, max(n, 1), per)]


def _holds_tensor(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return True
    if isinstance(obj, (tuple, list)):
        return any(_holds_tensor(o) for o in obj)
    if isinstance(obj, dict):
        return any(_holds_tensor(o) for o in obj.values())
    return False


@dataclasses.dataclass(frozen=True)
class _ChunkedView:
    """Decompress-only adapter: the W shard payloads of a stage-1 encode →
    the full flat leaf, so that a Memory's ``update`` (which only calls
    ``compressor.decompress``) sees the reconstruction of the whole buffer.
    ``ctx = (shard ctxs, n, shape, dtype, stage2)``. ``stage2`` is None, or
    two-shot's ``(e2, start)`` under ``stage2_feedback``: the owner's
    re-compression error ``e2``, subtracted at its chunk from ``start`` on,
    so that a residual memory (``compensated − decompress``) keeps it."""

    inner: Compressor

    def decompress(self, payload, ctx) -> torch.Tensor:
        ctxs, n, shape, dtype, stage2 = ctx
        flat = torch.cat([self.inner.decompress(p, c).reshape(-1)
                          for p, c in zip(payload, ctxs)])
        if stage2 is not None:
            e2, start = stage2
            stop = start + e2.numel()
            flat = torch.cat([flat[:start],
                              flat[start:stop] - e2.to(flat.dtype),
                              flat[stop:]])
        return flat[:n].reshape(shape).to(dtype)


@dataclasses.dataclass(frozen=True)
class _PipelinedView:
    """Decompress-only adapter over P segments' :class:`_ChunkedView` ctxs:
    each segment decodes on its own, and the segments concatenate back into
    the full leaf. ``ctx = (segment ctxs, n, shape, dtype)``, each segment
    ctx a :class:`_ChunkedView` ctx."""

    inner: Compressor

    def decompress(self, payload, ctx) -> torch.Tensor:
        seg_ctxs, n, shape, dtype = ctx
        view = _ChunkedView(self.inner)
        flat = torch.cat([view.decompress(p, c).reshape(-1)
                          for p, c in zip(payload, seg_ctxs)])
        return flat[:n].reshape(shape).to(dtype)


def _shard_compress(compressor: Compressor, chunks: torch.Tensor,
                    rng: LeafKey, comm_name: str, shared=None):
    """The stage-1 shard encode: ``compress`` of each of the ``(w, m)``
    shards under the shard-folded key ``rng.fold(c)``. Checks that there is
    a wire payload to send, and that ctx holds no tensor: ranks decode each
    other's shard payloads with their own ctx, which is sound only when ctx
    is a function of shapes alone (in the port, static Python data).
    ``shared`` is a negotiated value (the shared scale): every shard then
    encodes against it, and the ctx gate is waived, since a ctx seeded by
    a value that every rank negotiated alike is the same on every rank.
    Returns ``(payloads, ctxs)``, one entry per shard."""
    payloads, ctxs = [], []
    for c in range(chunks.shape[0]):
        if shared is None:
            payload, ctx, _ = compressor.compress(chunks[c], None,
                                                  rng.fold(c))
        else:
            payload, ctx, _ = compressor.compress(chunks[c], None,
                                                  rng.fold(c), shared=shared)
        if c == 0:
            if not payload:
                raise TypeError(
                    f"{comm_name} needs a wire payload to scatter; "
                    f"{type(compressor).__name__} communicates inside "
                    "compress: use Allreduce instead.")
            if shared is None and _holds_tensor(ctx):
                raise TypeError(
                    f"{comm_name} requires a data-free ctx; "
                    f"{type(compressor).__name__}.compress puts tensors in "
                    "ctx, and ranks decode each other's shard payloads with "
                    "their own ctx: keep data in the payload or use "
                    "Allgather/Allreduce.")
        payloads.append(tuple(payload))
        ctxs.append(ctx)
    return payloads, ctxs


def _stacked_decode(compressor: Compressor, stacked: Payload, ctx: Ctx,
                    k: int) -> torch.Tensor:
    """The ``k`` payloads of a ``(k, ...)`` stack decoded with one ctx and
    stacked: ``(k,) + shape``."""
    return torch.stack([compressor.decompress(_rank_payload(stacked, j), ctx)
                        for j in range(k)])


@dataclasses.dataclass(frozen=True)
class TwoShotAllreduce(Communicator):
    """Scatter, reduce, re-compress and gather: O(k) wire per rank.

    1. split the compensated gradient into W equal chunks
       (``Communicator.shard_spec``) and compress each under
       ``rng.fold(c)`` (error feedback covers exactly this encode);
    2. ``all_to_all`` the stacked chunk payloads: rank i receives every
       rank's payload for chunk i;
    3. decode those W payloads with chunk i's ctx, ``aggregate`` them (a
       sum or the majority vote; staged, as the JAX package does: a fused
       decode-accumulate would associate the sums differently) and scale
       by ``mean_scale(W)`` under ``average``;
    4. re-compress the aggregate under ``rng.fold(W)``, a key every rank
       holds, ``all_gather`` it, and decode every rank's chunk with this
       rank's own stage-2 ctx.

    Only for stateless codecs with a wire payload and a ctx free of data
    (``_shard_compress``'s gates): every rank decodes the others' chunks
    with its own ctx. ``stage2_feedback=True`` folds each owner's stage-2
    re-compression error into its residual at the owned chunk (×W under
    ``average``, so the mean repays it once), which needs a memory whose
    update is ``compensated − decompress``.
    """

    stage2_feedback: bool = False
    shard_parallel = True

    def _recv_total_bytes(self, payload_nbytes: int, n_elems: int,
                          world: int, vote: bool = False) -> int:
        # The stage-1 all_to_all and the stage-2 all_gather.
        return _ring_bytes(payload_nbytes, world)

    def step(self, x: torch.Tensor, mem_state, comp_state, memory,
             compressor: Compressor, rng: LeafKey):
        if comp_state is not None:
            raise TypeError(
                f"TwoShotAllreduce requires a stateless compressor; "
                f"{type(compressor).__name__} carries cross-step state "
                "(init_state != None) that has no per-chunk meaning — use "
                "Allgather/Allreduce instead.")
        shape, dtype = tuple(x.shape), x.dtype
        compensated, mem_state = memory.compensate(x, mem_state)
        flat = compensated.reshape(-1)
        n = flat.numel()
        w, m, pad = self.shard_spec(n)
        chunks = (torch.cat([flat, flat.new_zeros(pad)]) if pad
                  else flat).reshape(w, m)
        payloads, ctxs = _shard_compress(compressor, chunks, rng,
                                         "TwoShotAllreduce")
        if self.stage2_feedback and not (
                getattr(memory, "linear_feedback_coeffs", None) is not None
                or _is_identity_memory(memory)):
            raise TypeError(
                "TwoShotAllreduce(stage2_feedback=True) needs a memory whose "
                "update is compensated − decompress (ResidualMemory: "
                f"linear_feedback_coeffs); {type(memory).__name__} does not "
                "declare it. A keep-mask memory such as DgcMemory reads "
                "decompress()==0, and the injected stage-2 error would "
                "clear its accumulators across the whole owned chunk. Use "
                "ResidualMemory or disable stage2_feedback.")
        i = dist.get_rank(self.group)
        # Rank i now holds every rank's payload for chunk i.
        mine = _all_to_all(tuple(torch.stack(leaf) for leaf in
                                 zip(*payloads)), self.group)
        agg = compressor.aggregate(_stacked_decode(compressor, mine,
                                                   ctxs[i], w))
        if compressor.average:
            agg = agg * mean_scale(w)                         # agg / w
        agg = agg.to(chunks.dtype)
        payload2, ctx2, _ = compressor.compress(agg, None, rng.fold(w))
        stage2 = None
        if self.stage2_feedback:
            e2 = agg - compressor.decompress(payload2, ctx2)
            if compressor.average:
                e2 = e2 * w
            stage2 = (e2, i * m)
        mem_state = memory.update(compensated, payloads,
                                  (ctxs, n, shape, dtype, stage2),
                                  _ChunkedView(compressor), mem_state)
        out = _stacked_decode(compressor, _gather(tuple(payload2), self.group),
                              ctx2, w)
        return out.reshape(-1)[:n].reshape(shape).to(dtype), mem_state, \
            comp_state

    def exchange(self, payload: Payload, ctx: Ctx, compressor: Compressor
                 ) -> torch.Tensor:
        raise TypeError("TwoShotAllreduce re-chunks the gradient before "
                        "compression; it only supports the full step() "
                        "pipeline, not a bare exchange().")


@dataclasses.dataclass(frozen=True)
class RingAllreduce(Communicator):
    """Compressed ring all-reduce, the payload compressed on every hop:

    1. split the compensated gradient into W equal shards
       (``Communicator.shard_spec``) and compress each under the key
       ``rng.fold(c)`` (error feedback covers exactly this encode);
    2. reduce-scatter, W−1 hops: at hop s rank i sends the running partial
       of shard (i−1−s) mod W to rank i+1 and receives shard (i−2−s) mod W
       from rank i−1 (``dist.batch_isend_irecv``);
    3. all-gather the W reduced shards in wire format and decode them all.

    Three accumulation paths, gated on the codec:

    * **exact** (``payload_algebra='exact'``: none) — hops add wire words
      (``payload_add``); the mean scales the owned shard by
      ``mean_scale(W)`` before the gather.
    * **homomorphic** (``shared_scale``: homoqsgd; ``sketch``:
      countsketch) — the same payload-space hops (packed homoqsgd: the
      ``packed_int_accumulate`` kernel), bounded by the codec's
      ``payload_sum_max_world``. The shared scale is negotiated once over
      the whole buffer before the segmentation, so every segment and shard
      encodes against it; the mean scales the one final decode.
    * **requant** (``supports_hop_requant``: qsgd, signsgd, topk) — each
      hop runs ``decode_accumulate((recv, own))`` (qsgd and signsgd: one
      fused kernel) and re-compresses the partial under ``rng.fold(W+1+s)``
      for the next hop; the owner aggregates (the vote re-signs), averages,
      and encodes its shard once more under ``rng.fold(W)`` for the gather.

    ``pipeline=P > 1`` splits the buffer into P contiguous segments, each
    running the whole schedule under ``rng.fold(p)``. A one-rank ring makes
    no hop, and so no point-to-point call.
    """

    pipeline: int = 1
    shard_parallel = True

    def __post_init__(self):
        if self.pipeline < 1:
            raise ValueError(
                f"RingAllreduce pipeline must be >= 1; got {self.pipeline}: "
                "it is the number of segments the ring schedule splits the "
                "buffer into.")

    def wire_overlap_fraction(self) -> float:
        return _pipelined_overlap(self.pipeline)

    def _recv_total_bytes(self, payload_nbytes: int, n_elems: int,
                          world: int, vote: bool = False) -> int:
        # W−1 hop payloads and W−1 gathered shards of ~payload/W each. The
        # same at any pipeline depth: per-segment shard padding adds a few
        # elements, which the model leaves out.
        return _ring_bytes(payload_nbytes, world)

    def step(self, x: torch.Tensor, mem_state, comp_state, memory,
             compressor: Compressor, rng: LeafKey):
        if comp_state is not None:
            raise TypeError(
                f"RingAllreduce requires a stateless compressor; "
                f"{type(compressor).__name__} carries cross-step state "
                "(init_state != None) that has no per-shard meaning: use "
                "Allgather/Allreduce instead.")
        algebra = _algebra(compressor)
        homo = algebra in _HOMOMORPHIC
        exact = bool(getattr(compressor, "summable_payload", False))
        requant = bool(getattr(compressor, "supports_hop_requant", False))
        if not (exact or requant):
            raise TypeError(
                "RingAllreduce keeps the payload compressed on every hop, "
                "which needs a payload algebra (exact: none; shared_scale: "
                "homoqsgd; sketch: countsketch) or an opt-in to per-hop "
                "requantization (supports_hop_requant=True: "
                f"topk/qsgd/signsgd); {type(compressor).__name__} declares "
                "neither. Use Allgather instead.")
        shape, dtype = tuple(x.shape), x.dtype
        compensated, mem_state = memory.compensate(x, mem_state)
        flat = compensated.reshape(-1)
        n = flat.numel()
        if homo:
            _check_payload_sum_world(compressor, self.world_size(),
                                     "RingAllreduce")
        # The shared scale, negotiated once over the whole buffer before
        # the segmentation: every segment and shard encodes against it.
        shared = None
        if algebra == "shared_scale":
            with trace_stage(f"{STAGE_EXCHANGE}/negotiate_scale"):
                shared = compressor.negotiate(flat, self.group, rng=rng)
        segs = _pipeline_segments(n, self.pipeline)
        if len(segs) == 1:
            out, payloads, ctxs = self._segment_schedule(
                flat, compressor, rng, exact, homo, shared)
            view = _ChunkedView(compressor)
            view_ctx = (ctxs, n, shape, dtype, None)
        else:
            outs, seg_pay, seg_ctx = [], [], []
            for p, (lo, hi) in enumerate(segs):
                with trace_stage(f"{STAGE_PIPELINE}/{p}"):
                    o, pay, ctxs = self._segment_schedule(
                        flat[lo:hi], compressor, rng.fold(p), exact, homo,
                        shared)
                outs.append(o)
                seg_pay.append(pay)
                seg_ctx.append((ctxs, hi - lo, (hi - lo,), flat.dtype, None))
            out = torch.cat(outs)
            payloads = tuple(seg_pay)
            view, view_ctx = (_PipelinedView(compressor),
                              (tuple(seg_ctx), n, shape, dtype))
        # Error feedback covers the stage-1 encode exactly; the hop
        # requant losses are downstream of it.
        mem_state = memory.update(compensated, payloads, view_ctx, view,
                                  mem_state)
        return out[:n].reshape(shape).to(dtype), mem_state, comp_state

    def _segment_schedule(self, flat: torch.Tensor, compressor: Compressor,
                          rng: LeafKey, exact: bool, homo: bool, shared):
        """One full ring schedule over one contiguous flat segment: the
        stage-1 shard encode, the W−1 hops, the gather and the decode.
        Returns ``(decoded flat segment, stage-1 payloads, shard ctxs)``."""
        n = flat.numel()
        w, m, pad = self.shard_spec(n)
        chunks = (torch.cat([flat, flat.new_zeros(pad)]) if pad
                  else flat).reshape(w, m)
        payloads, ctxs = _shard_compress(compressor, chunks, rng,
                                         "RingAllreduce", shared=shared)
        i = dist.get_rank(self.group)
        nxt, prv = (i + 1) % w, (i - 1) % w
        if exact:
            # Payload-space accumulation: the wire format is the
            # accumulator (packed homoqsgd: a field-wise add), and phase 2
            # needs no re-encode.
            send = payloads[(i - 1) % w]
            for s in range(w - 1):
                recv = _shift(send, self.group, nxt, prv)
                send = compressor.payload_add(recv, payloads[(i - 2 - s) % w])
            out = _gather_decode(compressor, send, ctxs, w, homo, self.group,
                                 "RingAllreduce")
        else:
            hop_ctx = None
            send = payloads[(i - 1) % w]
            partial = None
            for s in range(w - 1):
                recv = _shift(send, self.group, nxt, prv)
                rc = (i - 2 - s) % w
                # Hop 0 arrives in the stage-1 format (shard rc's ctx);
                # later hops in the previous hop's requant format.
                rctx = ctxs[rc] if s == 0 else hop_ctx
                partial = compressor.decode_accumulate(
                    (recv, payloads[rc]), (rctx, ctxs[rc]))
                if s < w - 2:
                    pay, hop_ctx, _ = compressor.compress(
                        partial, None, rng.fold(w + 1 + s))
                    send = tuple(pay)
            if partial is None:                     # w == 1: nothing moved
                partial = compressor.decompress(payloads[0], ctxs[0])
            # A singleton stack: sum codecs pass through, vote codecs
            # re-sign the final tally.
            owned = compressor.aggregate(partial[None])
            out = _requant_gather_decode(compressor, owned, chunks.dtype,
                                         rng.fold(w), w, self.group)
        return out[:n], payloads, ctxs

    def exchange(self, payload: Payload, ctx: Ctx, compressor: Compressor
                 ) -> torch.Tensor:
        raise TypeError("RingAllreduce re-shards the gradient before "
                        "compression; it only supports the full step() "
                        "pipeline, not a bare exchange().")


def _shift(send: Payload, group, to: int, frm: int) -> Payload:
    """Send ``send`` to rank ``to`` of ``group`` and receive the payload of
    the same shapes from rank ``frm``, in one batch of point-to-point
    calls (integer tensors move as their bytes)."""
    peer = (lambda r: r) if group is None else (
        lambda r: dist.get_global_rank(group, r))
    bufs = [_wire(t) for t in send]
    recv = [torch.empty_like(b) for b in bufs]
    ops = [dist.P2POp(dist.isend, b, peer(to), group) for b in bufs]
    ops += [dist.P2POp(dist.irecv, r, peer(frm), group) for r in recv]
    with trace_stage(STAGE_RING_HOP):
        counters.count("send_recv", *bufs)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return tuple(r.view(t.dtype).view(t.shape) for r, t in zip(recv, send))


def _gather_decode(compressor: Compressor, owned: Payload, ctxs, w: int,
                   homo: bool, group, schedule: str) -> torch.Tensor:
    """Phase 2 of the exact and homomorphic paths: gather the owned
    shards' wire-format sums over ``group`` and decode shard ``j`` with
    shard ``j``'s ctx (member ``j`` owns shard ``j``). The mean over all
    ``w`` ranks scales float payloads before the gather, and the one
    decode of homomorphic payloads after it."""
    if compressor.average and not homo:
        if not all(t.is_floating_point() for t in owned):
            raise TypeError(
                f"{schedule} with average=True requires float payloads; "
                f"got {[t.dtype for t in owned]}: integer-coded payloads "
                "cannot carry the mean (shared_scale/sketch algebras "
                "divide after the final decode instead).")
        owned = tuple(t * mean_scale(w) for t in owned)          # t / w
    gathered = _gather(owned, group)
    out = torch.cat([
        compressor.decompress(_rank_payload(gathered, j), ctxs[j]).reshape(-1)
        for j in range(len(ctxs))])
    if homo and compressor.average:
        out = out * mean_scale(w)                                 # out / w
    return out


def _requant_gather_decode(compressor: Compressor, owned: torch.Tensor,
                           dtype, key: LeafKey, w: int, group
                           ) -> torch.Tensor:
    """Phase 2 of the requant paths: average the owned shard's aggregate
    over all ``w`` ranks, encode it once more under ``key`` (the ring's
    ``rng.fold(W)``: a key every rank holds, so one ctx decodes every
    rank's shard), gather over ``group`` and decode."""
    if compressor.average:
        owned = owned * mean_scale(w)                             # owned / w
    payload2, ctx2, _ = compressor.compress(owned.to(dtype), None, key)
    gathered = _gather(tuple(payload2), group)
    return torch.cat([
        compressor.decompress(_rank_payload(gathered, j), ctx2).reshape(-1)
        for j in range(gathered[0].shape[0])])


def _gathered_aggregate(base: Compressor, codec: Compressor, stacked: Payload,
                        ctx: Ctx, k: int) -> torch.Tensor:
    """Aggregate ``k`` gathered payloads (leading axis ``k`` on every
    tensor) that share one ctx: the requant boundary's decode-and-reduce.
    When the codec's wire kernel is live (``codec.wire_fused()``) and it
    overrides ``decode_accumulate``, the decode and the sum run as one
    K-way pass and the singleton ``aggregate`` re-signs vote tallies;
    otherwise each payload decodes on its own and ``base.aggregate``
    reduces the stack. The two associate float additions differently, so
    the fused spelling never replaces the staged one behind a disabled
    kernel. ``base`` gives the aggregation (sum or majority vote)."""
    parts = [tuple(t[j] for t in stacked) for j in range(k)]
    if (codec.wire_fused()
            and type(codec).decode_accumulate
            is not Compressor.decode_accumulate):
        partial = codec.decode_accumulate(parts, (ctx,) * k)
        return base.aggregate(partial[None])
    return base.aggregate(torch.stack([codec.decompress(p, ctx)
                                       for p in parts]))


@dataclasses.dataclass(frozen=True)
class ReduceScatterAllreduce(Communicator):
    """One-shot compressed reduce-scatter + all-gather (``communicator:
    "rscatter"``), one ``all_to_all`` and one ``all_gather`` in place of the
    ring's W−1 hops:

    1. split the compensated gradient into W equal chunks
       (``Communicator.shard_spec``) and compress each under
       ``rng.fold(c)``, after the shared-scale negotiation where the codec
       has one; error feedback covers exactly this encode;
    2. ``all_to_all`` the stacked chunk payloads: rank i receives every
       rank's payload for chunk i;
    3. reduce the owned chunk:

       * **exact / homomorphic** (``summable_payload``: none; homoqsgd,
         bounded by ``payload_sum_max_world``; countsketch) — the W
         payloads are summed in payload space (``payload_sum``; packed
         homoqsgd: the ``packed_int_accumulate`` kernel), with no
         re-encode anywhere;
       * **single requant** (``supports_hop_requant``: topk, qsgd,
         signsgd) — decode the W payloads and aggregate them (a one-shot
         sum or majority vote; qsgd and signsgd: one fused
         ``decode_accumulate`` pass when their kernel is live), then
         encode once under ``rng.fold(W)``;

    4. ``all_gather`` the reduced chunks, still in wire format, and decode
       all W locally.

    The same gates as the ring: a stateless codec, a wire payload, a ctx
    free of data (or a negotiated one), and a payload algebra or hop
    requant.
    """

    shard_parallel = True

    def _recv_total_bytes(self, payload_nbytes: int, n_elems: int,
                          world: int, vote: bool = False) -> int:
        # The all_to_all of the stage-1 payloads and the all_gather of the
        # reduced chunks.
        return _ring_bytes(payload_nbytes, world)

    def step(self, x: torch.Tensor, mem_state, comp_state, memory,
             compressor: Compressor, rng: LeafKey):
        if comp_state is not None:
            raise TypeError(
                f"ReduceScatterAllreduce requires a stateless compressor; "
                f"{type(compressor).__name__} carries cross-step state "
                "(init_state != None) that has no per-shard meaning — use "
                "Allgather/Allreduce instead.")
        algebra = _algebra(compressor)
        homo = algebra in _HOMOMORPHIC
        exact = bool(getattr(compressor, "summable_payload", False))
        requant = bool(getattr(compressor, "supports_hop_requant", False))
        if not (exact or requant):
            raise TypeError(
                f"ReduceScatterAllreduce sums or re-aggregates chunk "
                "payloads after the all_to_all, which needs a payload "
                "algebra (exact: none/fp16/randomk; shared_scale: "
                "homoqsgd; sketch: countsketch — exact payload-space "
                "summation at the owned chunk) or an opt-in to "
                "re-encoding the aggregate once "
                "(supports_hop_requant=True: topk/qsgd/signsgd); "
                f"{type(compressor).__name__} declares neither — its "
                "payload carries structure a partial sum destroys. Use "
                "Allgather (general-purpose) instead.")
        shape, dtype = tuple(x.shape), x.dtype
        compensated, mem_state = memory.compensate(x, mem_state)
        flat = compensated.reshape(-1)
        n = flat.numel()
        w, m, pad = self.shard_spec(n)
        if homo:
            _check_payload_sum_world(compressor, w, "ReduceScatterAllreduce")
        chunks = (torch.cat([flat, flat.new_zeros(pad)]) if pad
                  else flat).reshape(w, m)
        shared = None
        if algebra == "shared_scale":
            with trace_stage(f"{STAGE_EXCHANGE}/negotiate_scale"):
                shared = compressor.negotiate(flat, self.group, rng=rng)
        payloads, ctxs = _shard_compress(compressor, chunks, rng,
                                         "ReduceScatterAllreduce",
                                         shared=shared)
        # Error feedback covers the stage-1 encode exactly; the one
        # requant boundary (requant path only) is downstream of it.
        mem_state = memory.update(compensated, payloads,
                                  (ctxs, n, shape, dtype, None),
                                  _ChunkedView(compressor), mem_state)
        i = dist.get_rank(self.group)
        # Rank i now holds every rank's payload for chunk i.
        mine = _all_to_all(tuple(torch.stack(leaf) for leaf in
                                 zip(*payloads)), self.group)
        if exact:
            owned = compressor.payload_sum(mine)
            out = _gather_decode(compressor, owned, ctxs, w, homo,
                                 self.group, "ReduceScatterAllreduce")
        else:
            agg = _gathered_aggregate(compressor, compressor, mine, ctxs[i],
                                      w)
            out = _requant_gather_decode(compressor, agg, chunks.dtype,
                                         rng.fold(w), w, self.group)
        return out[:n].reshape(shape).to(dtype), mem_state, comp_state

    def exchange(self, payload: Payload, ctx: Ctx, compressor: Compressor
                 ) -> torch.Tensor:
        raise TypeError("ReduceScatterAllreduce re-shards the gradient "
                        "before compression; it only supports the full "
                        "step() pipeline, not a bare exchange().")


# -- the hierarchical (multi-level) all-reduce -------------------------------

# (parent group, W, S, Kr, R) -> {level: this rank's process group}. Built
# once, at the first step of a layout, and kept: process groups are made by
# collective calls, never per leaf or per step.
_HIER_GROUPS: dict = {}


def _hier_rank_lists(w: int, s: int, kr: int, r: int) -> dict:
    """The rank lists of each level, in the JAX package's order: ``intra``
    are the slices; ``dcn`` the Kr slices of one region that share a local
    index (with one region: every slice); ``wan`` one rank a region that
    share (slice in region, local index)."""
    k = kr * r
    lists = {"intra": [[kk * s + ll for ll in range(s)] for kk in range(k)]}
    if r > 1:
        rz = kr * s
        lists["dcn"] = [[rho * rz + kk * s + ll for kk in range(kr)]
                        for rho in range(r) for ll in range(s)]
        lists["wan"] = [[rho * rz + kk * s + ll for rho in range(r)]
                        for kk in range(kr) for ll in range(s)]
    else:
        lists["dcn"] = [[kk * s + ll for kk in range(k)] for ll in range(s)]
    return lists


def _hier_groups(parent, w: int, s: int, kr: int, r: int) -> dict:
    """This rank's process group at each level of a (W, S, Kr, R) layout
    over ``parent``. Every rank calls ``new_group`` for every group of
    every level in one order; with ``use_local_synchronization`` a rank
    outside a group returns at once, so a parent smaller than the default
    group works too. A group ranks its members by ascending global rank,
    which is the order of JAX's rank lists, so a gather stacks them as
    JAX's grouped ``all_gather`` does. A single slice (K=1) needs none:
    its one slice is the parent itself."""
    key = (parent if parent is not None else dist.group.WORLD, w, s, kr, r)
    hit = _HIER_GROUPS.get(key)
    if hit is not None:
        return hit
    if kr * r == 1:
        hit = {"intra": parent}
    else:
        me = dist.get_rank(parent)
        hit = {}
        for level, lists in _hier_rank_lists(w, s, kr, r).items():
            for ranks in lists:
                pg = dist.new_group(
                    [j if parent is None else dist.get_global_rank(parent, j)
                     for j in ranks], use_local_synchronization=True)
                if me in ranks:
                    hit[level] = pg
    _HIER_GROUPS[key] = hit
    return hit


@dataclasses.dataclass(frozen=True)
class HierarchicalAllreduce(Communicator):
    """Multi-level compressed all-reduce (``communicator: "hier"``): most
    traffic stays on the fast links inside a slice, and only the
    S-times-smaller slice partials cross the slower network.

    With ``slice_size=S`` on ``W = K·S`` ranks (ranks ``[k·S, (k+1)·S)``
    form slice ``k``, the :class:`~grace_tpu_torch.core.Topology` layout;
    on GPUs a slice is the ranks of one NVLink node):

    1. **intra-slice ring reduce-scatter**: the compensated gradient is
       split into S shards and each is encoded under ``rng.fold(c)``
       (``_shard_compress``; error feedback covers exactly this encode),
       then S−1 hops rotate within each slice only (rank ``j`` sends to
       ``(j//S)·S + (j%S + 1) % S``). Local rank ℓ of every slice then
       holds its slice's partial of shard ℓ.
    2. **cross-slice exchange**: the K ranks that share a local index
       gather their partials (one gather in a K-member group). Exact and
       homomorphic payloads (``summable_payload``) sum in payload space
       (``payload_sum``), with no re-encode; requant codecs
       (``supports_hop_requant``) encode the partial once more under
       ``rng.fold(2S)``, gather, and decode and aggregate the K partials
       (``_gathered_aggregate``: a sum, or the cascaded majority vote; one
       fused ``decode_accumulate`` where the codec's kernel is live).
    3. **intra-slice all-gather**: each slice gathers its S reduced shards,
       still in wire format (requant codecs after one more encode under
       ``rng.fold(2S+1)``), and decodes them.

    ``region_size=Rz`` (ranks; ``Kr = Rz/S`` slices a region, ``R = W/Rz``
    regions) adds a third level: the boundary partial is first summed
    within the region (the Kr-member ``dcn`` groups), then across regions
    (the R-member ``wan`` groups). Exact payloads cross it still summable;
    requant codecs encode the region partial once under ``rng.fold(2S+2)``,
    through ``wan_compressor`` when one is given (a ``supports_hop_requant``
    codec with a ctx free of data), and aggregate it with the base codec's
    semantics.

    ``slice_size=None`` or ``world <= slice_size`` is one slice: the
    schedule is the flat ring's, except that a requant codec's last encode
    runs under ``rng.fold(2S+1)`` where the ring's runs under
    ``rng.fold(W)``, as in the JAX package (the two are then equal bit for
    bit for every codec whose encode draws no noise). ``region_size=None``,
    ``world <= region_size`` or one region is the two-level schedule. A
    world that S or Rz does not divide raises ValueError.

    The subgroups of a layout are built once, at its first step, and
    cached (``_hier_groups``); a gather stacks the members in the order of
    the JAX package's rank lists, which sets the order of the sums. Same
    gates as the ring: a stateless codec, a wire payload, a ctx free of
    data, and a payload algebra or hop requant. ``pipeline=P`` runs the
    whole schedule on P contiguous segments under ``rng.fold(p)``.
    """

    slice_size: Optional[int] = None
    region_size: Optional[int] = None
    wan_compressor: Optional[Compressor] = None
    pipeline: int = 1
    shard_parallel = True

    def __post_init__(self):
        if self.pipeline < 1:
            raise ValueError(
                "HierarchicalAllreduce pipeline must be >= 1; got "
                f"{self.pipeline} — it is the number of double-buffered "
                "buffer segments, each running the full multi-level "
                "schedule (the RingAllreduce.pipeline semantics applied "
                "to the intra-slice ring and both boundary exchanges).")
        if self.slice_size is not None and self.slice_size < 1:
            raise ValueError(f"slice_size must be >= 1 or None; "
                             f"got {self.slice_size}")
        if self.region_size is not None:
            if self.slice_size is None:
                raise ValueError(
                    "HierarchicalAllreduce(region_size=...) requires "
                    "slice_size — the region tier groups whole ICI slices, "
                    "so a three-level schedule without a slice level is "
                    f"contradictory (got region_size={self.region_size}, "
                    "slice_size=None).")
            if (self.region_size < self.slice_size
                    or self.region_size % self.slice_size):
                raise ValueError(
                    f"region_size {self.region_size} must be a whole "
                    f"multiple of slice_size {self.slice_size} — regions "
                    "are made of whole slices (the Topology contract).")
        if self.wan_compressor is not None and self.region_size is None:
            raise ValueError(
                "HierarchicalAllreduce(wan_compressor=...) without "
                "region_size — there is no WAN level to re-encode for; "
                "set region_size or drop the WAN codec.")

    def shrunk(self, topology: Topology) -> "HierarchicalAllreduce":
        """The communicator for the world ``topology`` describes after a
        resize (``Topology.shrink``): its tier widths, and the WAN codec
        only while a region tier survives."""
        wan = (self.wan_compressor if topology.region_size is not None
               else None)
        return dataclasses.replace(self, slice_size=topology.slice_size,
                                   region_size=topology.region_size,
                                   wan_compressor=wan)

    def wire_overlap_fraction(self) -> float:
        return _pipelined_overlap(self.pipeline)

    def _split(self, world: int) -> tuple[int, int]:
        """(intra-slice size S, slice count K) at ``world`` ranks."""
        s = self.slice_size
        if s is None or world <= s:
            return max(1, world), 1
        if world % s:
            raise ValueError(
                f"HierarchicalAllreduce(slice_size={s}) does not divide "
                f"world size {world} — the two-level schedule needs whole "
                "slices (ranks [k*S, (k+1)*S) per slice); run on a "
                "world that is a multiple of slice_size or adjust "
                "slice_size to the physical slice width.")
        return s, world // s

    def _split3(self, world: int) -> tuple[int, int, int]:
        """(S, Kr slices a region, R regions); ``R == 1`` is the two-level
        schedule, with Kr its K."""
        s, k = self._split(world)
        rz = self.region_size
        if rz is None or k == 1 or world <= rz:
            return s, k, 1
        if world % rz:
            raise ValueError(
                f"HierarchicalAllreduce(region_size={rz}) does not divide "
                f"world size {world} — the three-level schedule needs "
                "whole regions (ranks [r*Rz, (r+1)*Rz) per region); run "
                "on a world that is a multiple of region_size or adjust "
                "region_size to the physical region width.")
        return s, rz // s, world // rz

    def _wan_leg_nbytes(self, payload_nbytes: int, n_elems: int,
                        s: int, r: int) -> int:
        """One rank's WAN-leg bytes: R−1 region partials of one shard, at
        the WAN codec's own payload width on the padded float32 shard when
        one is given, else at the base payload's share of a shard."""
        if r <= 1:
            return 0
        per = payload_nbytes // max(1, s)
        if self.wan_compressor is not None:
            from grace_tpu_torch.utils.metrics import payload_nbytes as pnb
            n = int(n_elems)
            shard = (n + (-n) % max(1, s)) // max(1, s)
            per = int(pnb(self.wan_compressor, ((shard,), torch.float32)))
        return (r - 1) * per

    def _recv_total_bytes(self, payload_nbytes: int, n_elems: int,
                          world: int, vote: bool = False) -> int:
        s, kr, r = self._split3(world)
        # S−1 hops and S−1 gathered shards of ~payload/S; Kr−1 cross-slice
        # partials of ~payload/S; R−1 cross-region partials.
        intra = _ring_bytes(payload_nbytes, s)
        dcn = (kr - 1) * payload_nbytes // max(1, s)
        return intra + dcn + self._wan_leg_nbytes(payload_nbytes, n_elems,
                                                  s, r)

    def recv_link_bytes(self, payload_nbytes: int, n_elems: int, world: int,
                        topology: Optional[Topology] = None,
                        vote: bool = False) -> LinkBytes:
        """The mixed split: intra-slice legs on ``ici``, the cross-slice
        gather on ``dcn``, the cross-region gather on ``wan``, when the
        schedule's groups nest inside the physical ones. Otherwise it
        degrades tier by tier: slices that straddle physical slices price
        everything at the worst tier the group spans, and regions that
        straddle physical regions (or a two-level schedule over three
        tiers) put the whole cross-slice bill on ``wan``."""
        total = int(self._recv_total_bytes(payload_nbytes, n_elems, world,
                                           vote=vote))
        topo = topology if topology is not None else SINGLE_SLICE
        if not topo.crosses_dcn(world):
            return LinkBytes(ici=total, dcn=0)
        s, kr, r = self._split3(world)
        k = kr * r
        aligned = (k > 1 and topo.slice_size is not None
                   and s <= topo.slice_size and topo.slice_size % s == 0)
        if not aligned:
            if topo.crosses_wan(world):
                return LinkBytes(ici=0, dcn=0, wan=total)
            return LinkBytes(ici=0, dcn=total)
        intra = _ring_bytes(payload_nbytes, s)
        cross = total - intra
        if not topo.crosses_wan(world):
            return LinkBytes(ici=intra, dcn=cross)
        region_aligned = (r > 1 and topo.region_size is not None
                          and self.region_size <= topo.region_size
                          and topo.region_size % self.region_size == 0)
        if not region_aligned:
            return LinkBytes(ici=intra, dcn=0, wan=cross)
        dcn_leg = (kr - 1) * payload_nbytes // max(1, s)
        return LinkBytes(ici=intra, dcn=dcn_leg, wan=cross - dcn_leg)

    def step(self, x: torch.Tensor, mem_state, comp_state, memory,
             compressor: Compressor, rng: LeafKey):
        if comp_state is not None:
            raise TypeError(
                f"HierarchicalAllreduce requires a stateless compressor; "
                f"{type(compressor).__name__} carries cross-step state "
                "(init_state != None) that has no per-shard meaning — use "
                "Allgather/Allreduce instead.")
        algebra = _algebra(compressor)
        homo = algebra in _HOMOMORPHIC
        exact = bool(getattr(compressor, "summable_payload", False))
        requant = bool(getattr(compressor, "supports_hop_requant", False))
        if not (exact or requant):
            raise TypeError(
                f"HierarchicalAllreduce keeps the payload compressed on "
                "every hop and re-aggregates the per-slice partials, which "
                "needs a payload algebra (exact: none/fp16/randomk; "
                "shared_scale: homoqsgd; sketch: countsketch — exact "
                "payload-space accumulation through BOTH levels) or an "
                "opt-in to per-hop requantization "
                "(supports_hop_requant=True: topk/qsgd/signsgd); "
                f"{type(compressor).__name__} declares neither — its "
                "payload carries structure a partial sum destroys. Use "
                "Allgather (general-purpose) or TwoShotAllreduce instead.")
        w = self.world_size()
        s, kr, r = self._split3(w)
        if self.wan_compressor is not None:
            if exact:
                raise TypeError(
                    f"HierarchicalAllreduce(wan_compressor="
                    f"{type(self.wan_compressor).__name__}) with "
                    f"{type(compressor).__name__}: exact/homomorphic "
                    "payloads cross WAN exactly-summable — that zero-"
                    "requant property is the whole reason to use them, and "
                    "a WAN re-encode would break the payload-space sum "
                    "while adding loss. Drop wan_compressor, or pair it "
                    "with a supports_hop_requant base codec.")
            if not getattr(self.wan_compressor, "supports_hop_requant",
                           False):
                raise TypeError(
                    "HierarchicalAllreduce wan_compressor re-encodes the "
                    "region partial at the region boundary — a hop requant "
                    "one level up — so it must declare "
                    "supports_hop_requant (topk/qsgd/signsgd); "
                    f"{type(self.wan_compressor).__name__} does not.")
        # The whole sum spans all W ranks, so the shared-scale bound is on
        # W, not S.
        if homo:
            _check_payload_sum_world(compressor, w, "HierarchicalAllreduce")
        shape, dtype = tuple(x.shape), x.dtype
        compensated, mem_state = memory.compensate(x, mem_state)
        flat = compensated.reshape(-1)
        n = flat.numel()
        # One shared scale over the whole group and buffer, before the
        # segmentation: a per-slice scale would break the cross-slice sum.
        shared = None
        if algebra == "shared_scale":
            with trace_stage(f"{STAGE_EXCHANGE}/negotiate_scale"):
                shared = compressor.negotiate(flat, self.group, rng=rng)
        groups = _hier_groups(self.group, w, s, kr, r)
        layout = (w, s, kr, r, groups)
        segs = _pipeline_segments(n, self.pipeline)
        if len(segs) == 1:
            out, payloads, ctxs = self._segment_schedule(
                flat, compressor, rng, shared, homo, exact, layout)
            view = _ChunkedView(compressor)
            view_ctx = (ctxs, n, shape, dtype, None)
        else:
            outs, seg_pay, seg_ctx = [], [], []
            for p, (lo, hi) in enumerate(segs):
                with trace_stage(f"{STAGE_PIPELINE}/{p}"):
                    o, pay, ctxs = self._segment_schedule(
                        flat[lo:hi], compressor, rng.fold(p), shared, homo,
                        exact, layout)
                outs.append(o)
                seg_pay.append(pay)
                seg_ctx.append((ctxs, hi - lo, (hi - lo,), flat.dtype, None))
            out = torch.cat(outs)
            payloads = tuple(seg_pay)
            view, view_ctx = (_PipelinedView(compressor),
                              (tuple(seg_ctx), n, shape, dtype))
        # Error feedback covers the stage-1 encode exactly; the hop requants
        # and the boundary encodes are downstream of it.
        mem_state = memory.update(compensated, payloads, view_ctx, view,
                                  mem_state)
        return out[:n].reshape(shape).to(dtype), mem_state, comp_state

    def _segment_schedule(self, flat: torch.Tensor, compressor: Compressor,
                          rng: LeafKey, shared, homo: bool, exact: bool,
                          layout):
        """One whole multi-level schedule over one contiguous segment: the
        stage-1 encode into S shards, the S−1 intra-slice hops, the
        boundary exchanges, the intra-slice gather and the decode. Returns
        ``(decoded segment, stage-1 payloads, shard ctxs)``."""
        w, s, kr, r, groups = layout
        n = flat.numel()
        pad = (-n) % s
        chunks = (torch.cat([flat, flat.new_zeros(pad)]) if pad
                  else flat).reshape(s, -1)
        payloads, ctxs = _shard_compress(compressor, chunks, rng,
                                         "HierarchicalAllreduce",
                                         shared=shared)
        i = dist.get_rank(self.group)
        local, base = i % s, i - i % s
        # Rotate within the slice only: no hop crosses a slice boundary.
        nxt, prv = base + (local + 1) % s, base + (local - 1) % s
        intra = groups["intra"]
        if exact:
            send = payloads[(local - 1) % s]
            for hop in range(s - 1):
                recv = _shift(send, self.group, nxt, prv)
                send = compressor.payload_add(recv,
                                              payloads[(local - 2 - hop) % s])
            owned = send          # the slice's partial of shard `local`
            if kr * r > 1:
                owned = compressor.payload_sum(_gather(owned, groups["dcn"]))
                if r > 1:
                    owned = compressor.payload_sum(
                        _gather(owned, groups["wan"]))
            out = _gather_decode(compressor, owned, ctxs, w, homo, intra,
                                 "HierarchicalAllreduce")
        else:
            hop_ctx = None
            send = payloads[(local - 1) % s]
            partial = None
            for hop in range(s - 1):
                recv = _shift(send, self.group, nxt, prv)
                rc = (local - 2 - hop) % s
                # Hop 0 arrives in the stage-1 format (shard rc's ctx);
                # later hops in the previous hop's requant format.
                rctx = ctxs[rc] if hop == 0 else hop_ctx
                partial = compressor.decode_accumulate(
                    (recv, payloads[rc]), (rctx, ctxs[rc]))
                if hop < s - 2:
                    pay, hop_ctx, _ = compressor.compress(
                        partial, None, rng.fold(s + 1 + hop))
                    send = tuple(pay)
            if partial is None:                 # s == 1: one-rank slices
                partial = compressor.decompress(payloads[0], ctxs[0])
            if kr * r > 1:
                # The one slice-boundary encode; every rank of a cross-slice
                # group then aggregates the same Kr partials.
                payload_b, ctx_b, _ = compressor.compress(
                    partial, None, rng.fold(2 * s))
                agg = _gathered_aggregate(
                    compressor, compressor,
                    _gather(tuple(payload_b), groups["dcn"]), ctx_b, kr)
                if r > 1:
                    agg = self._region_boundary(compressor, agg,
                                                chunks.dtype, rng, s, r,
                                                groups["wan"])
            else:
                # A singleton stack: sum codecs pass through, vote codecs
                # re-sign the final tally, as on the flat ring.
                agg = compressor.aggregate(partial[None])
            out = _requant_gather_decode(compressor, agg, chunks.dtype,
                                         rng.fold(2 * s + 1), w, intra)
        return out[:n], payloads, ctxs

    def _region_boundary(self, compressor: Compressor, agg: torch.Tensor,
                         dtype, rng: LeafKey, s: int, r: int,
                         wan) -> torch.Tensor:
        """The one region-boundary encode: every rank of a ``dcn`` group
        holds the same region partial; it is encoded under
        ``rng.fold(2S+2)`` (by the WAN codec when one is given), gathered
        over the R regions, and aggregated with the base codec's
        semantics."""
        codec = self.wan_compressor or compressor
        payload_w, ctx_w, _ = codec.compress(agg.to(dtype), None,
                                             rng.fold(2 * s + 2))
        if self.wan_compressor is not None and _holds_tensor(ctx_w):
            raise TypeError(
                "HierarchicalAllreduce wan_compressor needs a data-free "
                "ctx — ranks decode each other's region partials with "
                "locally derived ctx; "
                f"{type(self.wan_compressor).__name__}.compress puts "
                "data-derived arrays in ctx.")
        return _gathered_aggregate(compressor, codec,
                                   _gather(tuple(payload_w), wan), ctx_w, r)

    def exchange(self, payload: Payload, ctx: Ctx, compressor: Compressor
                 ) -> torch.Tensor:
        raise TypeError("HierarchicalAllreduce re-shards the gradient "
                        "before compression; it only supports the full "
                        "step() pipeline, not a bare exchange().")
