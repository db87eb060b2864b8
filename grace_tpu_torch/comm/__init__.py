"""Communicators over ``torch.distributed``; counterpart of the JAX
``comm/__init__.py`` (``Allreduce`` with its majority-vote routing and its
homomorphic path, ``Allgather``, ``Broadcast``, ``SignAllreduce``,
``RingAllreduce``, ``ReduceScatterAllreduce`` and ``Identity``; the
two-shot and hierarchical communicators are queued in ROADMAP).

NCCL carries them on the card, gloo in the CPU tests. A world of one rank
still makes the real collective calls, except the ring's point-to-point
hops, of which a one-rank ring has none.

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

import torch
import torch.distributed as dist

from grace_tpu_torch.core import (Communicator, Compressor, Ctx, LeafKey,
                                  Memory, Payload, mean_scale)

__all__ = ["Allreduce", "Allgather", "Broadcast", "Identity",
           "SignAllreduce", "RingAllreduce", "ReduceScatterAllreduce",
           "vote_exact_max_world"]

# Newer PyTorch renames all_gather_into_tensor (same signature) and
# deprecates the old name.
_all_gather_into = (getattr(dist, "all_gather_single", None)
                    or dist.all_gather_into_tensor)

_HOMOMORPHIC = ("shared_scale", "sketch")


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
        dist.all_reduce(wide, op=dist.ReduceOp.SUM, group=group)
        t.copy_(wide)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)


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
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    out = (summed >= 0).to(vdt) * 2 - 1
    return out.to(dec.dtype)


def _is_identity_memory(memory) -> bool:
    """A memory whose compensate and update are the base no-ops (none)."""
    return (type(memory).compensate is Memory.compensate
            and type(memory).update is Memory.update)


def _vote_step_leaves(comm: Communicator, xs, mem_states, comp_states,
                      memory, compressor, rngs, vote_dtype: str):
    """``step_leaves`` of the all-reduce vote: the leaves that the codec's
    grouped compress takes (signsgd under linear error feedback or no
    memory) go through one grouped sign-pack, one decode of the
    concatenated payload, one all-reduce and one re-sign; the other leaves
    run ``comm.step``. Bit-identical to ``step`` leaf by leaf."""
    compress = getattr(compressor, "fused_feedback_compress_leaves", None)
    coeffs = getattr(memory, "linear_feedback_coeffs", None)
    grouped = None
    if (getattr(compressor, "vote_aggregate", False) and compress is not None
            and (coeffs is not None or _is_identity_memory(memory))):
        grouped = compress(xs, mem_states, coeffs, rngs)
    if grouped is None:
        return Communicator.step_leaves(comm, xs, mem_states, comp_states,
                                        memory, compressor, rngs)
    taken, payload, ctx, new_mem = grouped
    # Every rank takes the same leaves (the gates read shapes and dtypes
    # only), so the collectives line up.
    voted = _psum_majority_vote(compressor.decompress_leaves(payload, ctx),
                                comm.group, vote_dtype)
    return _merge_leaves(comm, xs, mem_states, comp_states, memory,
                         compressor, rngs, taken,
                         compressor.leaf_views(voted, ctx), new_mem)


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
    for t in payload:
        buf = _wire(t)
        out = torch.empty(world * buf.numel(), dtype=buf.dtype,
                          device=buf.device)
        _all_gather_into(out, buf, group=group)
        gathered.append(out.view(t.dtype).view((world,) + tuple(t.shape)))
    return tuple(gathered)


def _all_to_all(stacked: Payload, group) -> Payload:
    """The reduce-scatter's data movement: every ``(W, ...)`` stack of
    per-chunk payloads goes through one ``all_to_all_single``, after which
    row ``j`` holds rank ``j``'s payload for this rank's chunk."""
    out = []
    for s in stacked:
        buf = _wire(s)
        recv = torch.empty_like(buf)
        dist.all_to_all_single(recv, buf, group=group)
        out.append(recv.view(s.dtype).view(s.shape))
    return tuple(out)


def _rank_payload(gathered: Payload, j: int) -> Payload:
    return tuple(t[j] for t in gathered)


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

    def step_leaves(self, xs, mem_states, comp_states, memory, compressor,
                    rngs):
        """The vote routing groups leaves as :class:`SignAllreduce` does;
        every other codec runs :meth:`step` leaf by leaf."""
        return _vote_step_leaves(self, xs, mem_states, comp_states, memory,
                                 compressor, rngs, self.vote_dtype)

    def exchange(self, payload: Payload, ctx: Ctx, compressor: Compressor
                 ) -> torch.Tensor:
        if getattr(compressor, "vote_aggregate", False):
            return _psum_majority_vote(compressor.decompress(payload, ctx),
                                       self.group, self.vote_dtype)
        if not getattr(compressor, "summable_payload", False):
            raise TypeError(
                f"Allreduce requires a payload that sums meaningfully across "
                f"ranks; {type(compressor).__name__} does not declare "
                "summable_payload=True (its per-rank payloads decode "
                "differently, e.g. per-rank indices or norms). Use "
                "Allgather/Broadcast instead.")
        homo = _algebra(compressor) in _HOMOMORPHIC
        if homo:
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
        for t in payload:
            _all_reduce_sum(t, self.group)
        summed = tuple(payload)
        if homo:
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
                    rngs):
        coeffs = getattr(memory, "linear_feedback_coeffs", None)
        compress = getattr(compressor, "fused_feedback_compress_leaves", None)
        aggregate = getattr(compressor, "fused_aggregate_decompress_leaves",
                            None)
        grouped = None
        if coeffs is not None and compress is not None and aggregate is not None:
            grouped = compress(xs, mem_states, coeffs, rngs)
        if grouped is None:
            return super().step_leaves(xs, mem_states, comp_states, memory,
                                       compressor, rngs)
        taken, payload, ctx, new_mem = grouped
        # Concatenated payloads gather as one tensor each; every rank takes
        # the same leaves (the gates read shapes and dtypes only), so the
        # collectives line up.
        outs = aggregate(_gather(payload, self.group), ctx, self.world_size())
        return _merge_leaves(self, xs, mem_states, comp_states, memory,
                             compressor, rngs, taken, outs, new_mem)

    def exchange(self, payload: Payload, ctx: Ctx, compressor: Compressor
                 ) -> torch.Tensor:
        world = self.world_size()
        gathered = _gather(payload, self.group)
        fused = getattr(compressor, "fused_aggregate_decompress", None)
        if fused is not None:
            out = fused(gathered, ctx, world)
            if out is not None:        # handles aggregate + average itself
                return out
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

    def step_leaves(self, xs, mem_states, comp_states, memory, compressor,
                    rngs):
        return _vote_step_leaves(self, xs, mem_states, comp_states, memory,
                                 compressor, rngs, self.vote_dtype)

    def exchange(self, payload: Payload, ctx: Ctx, compressor: Compressor
                 ) -> torch.Tensor:
        if not getattr(compressor, "vote_aggregate", False):
            raise TypeError(
                "SignAllreduce implements majority-vote aggregation; "
                f"{type(compressor).__name__} does not declare "
                "vote_aggregate=True (its aggregate carries scaling the "
                "re-sign would drop): use Allreduce/Allgather instead.")
        return _psum_majority_vote(compressor.decompress(payload, ctx),
                                   self.group, self.vote_dtype)


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
    ``ctx = (shard ctxs, n, shape, dtype)``."""

    inner: Compressor

    def decompress(self, payload, ctx) -> torch.Tensor:
        ctxs, n, shape, dtype = ctx
        flat = torch.cat([self.inner.decompress(p, c).reshape(-1)
                          for p, c in zip(payload, ctxs)])
        return flat[:n].reshape(shape).to(dtype)


@dataclasses.dataclass(frozen=True)
class _PipelinedView:
    """Decompress-only adapter over P segments' :class:`_ChunkedView` ctxs:
    each segment decodes on its own, and the segments concatenate back into
    the full leaf. ``ctx = (segment ctxs, n, shape, dtype)``."""

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
            shared = compressor.negotiate(flat, self.group, rng=rng)
        segs = _pipeline_segments(n, self.pipeline)
        if len(segs) == 1:
            out, payloads, ctxs = self._segment_schedule(
                flat, compressor, rng, exact, homo, shared)
            view, view_ctx = _ChunkedView(compressor), (ctxs, n, shape, dtype)
        else:
            outs, seg_pay, seg_ctx = [], [], []
            for p, (lo, hi) in enumerate(segs):
                o, pay, ctxs = self._segment_schedule(
                    flat[lo:hi], compressor, rng.fold(p), exact, homo,
                    shared)
                outs.append(o)
                seg_pay.append(pay)
                seg_ctx.append((ctxs, hi - lo, (hi - lo,), flat.dtype))
            out = torch.cat(outs)
            payloads = tuple(seg_pay)
            view, view_ctx = (_PipelinedView(compressor),
                              (tuple(seg_ctx), n, shape, dtype))
        # Error feedback covers the stage-1 encode exactly; the hop
        # requant losses are downstream of it.
        mem_state = memory.update(compensated, payloads, view_ctx, view,
                                  mem_state)
        return out[:n].reshape(shape).to(dtype), mem_state, comp_state

    def _shift(self, send: Payload) -> Payload:
        """Send ``send`` to the next rank and receive the previous rank's
        payload of the same shapes."""
        w = dist.get_world_size(self.group)
        i = dist.get_rank(self.group)
        peer = (lambda r: r) if self.group is None else (
            lambda r: dist.get_global_rank(self.group, r))
        bufs = [_wire(t) for t in send]
        recv = [torch.empty_like(b) for b in bufs]
        ops = [dist.P2POp(dist.isend, b, peer((i + 1) % w), self.group)
               for b in bufs]
        ops += [dist.P2POp(dist.irecv, r, peer((i - 1) % w), self.group)
                for r in recv]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return tuple(r.view(t.dtype).view(t.shape)
                     for r, t in zip(recv, send))

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
        if exact:
            # Payload-space accumulation: the wire format is the
            # accumulator (packed homoqsgd: a field-wise add), and phase 2
            # needs no re-encode.
            send = payloads[(i - 1) % w]
            for s in range(w - 1):
                recv = self._shift(send)
                send = compressor.payload_add(recv, payloads[(i - 2 - s) % w])
            out = _gather_decode(compressor, send, ctxs, w, homo, self.group,
                                 "RingAllreduce")
        else:
            hop_ctx = None
            send = payloads[(i - 1) % w]
            partial = None
            for s in range(w - 1):
                recv = self._shift(send)
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
                                         rng, w, self.group)
        return out[:n], payloads, ctxs

    def exchange(self, payload: Payload, ctx: Ctx, compressor: Compressor
                 ) -> torch.Tensor:
        raise TypeError("RingAllreduce re-shards the gradient before "
                        "compression; it only supports the full step() "
                        "pipeline, not a bare exchange().")


def _gather_decode(compressor: Compressor, owned: Payload, ctxs, w: int,
                   homo: bool, group, schedule: str) -> torch.Tensor:
    """Phase 2 of the exact and homomorphic paths: gather the owned
    shards' wire-format sums and decode shard ``j`` with shard ``j``'s ctx
    (rank ``j`` owns shard ``j``). The mean scales float payloads before
    the gather, and the one decode of homomorphic payloads after it."""
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
        for j in range(w)])
    if homo and compressor.average:
        out = out * mean_scale(w)                                 # out / w
    return out


def _requant_gather_decode(compressor: Compressor, owned: torch.Tensor,
                           dtype, rng: LeafKey, w: int, group
                           ) -> torch.Tensor:
    """Phase 2 of the requant paths: average the owned shard's aggregate,
    encode it once more under ``rng.fold(W)`` (a key every rank holds, so
    one ctx decodes every rank's shard), gather and decode."""
    if compressor.average:
        owned = owned * mean_scale(w)                             # owned / w
    payload2, ctx2, _ = compressor.compress(owned.to(dtype), None,
                                            rng.fold(w))
    gathered = _gather(tuple(payload2), group)
    return torch.cat([
        compressor.decompress(_rank_payload(gathered, j), ctx2).reshape(-1)
        for j in range(w)])


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
            shared = compressor.negotiate(flat, self.group, rng=rng)
        payloads, ctxs = _shard_compress(compressor, chunks, rng,
                                         "ReduceScatterAllreduce",
                                         shared=shared)
        # Error feedback covers the stage-1 encode exactly; the one
        # requant boundary (requant path only) is downstream of it.
        mem_state = memory.update(compensated, payloads,
                                  (ctxs, n, shape, dtype),
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
            out = _requant_gather_decode(compressor, agg, chunks.dtype, rng,
                                         w, self.group)
        return out[:n].reshape(shape).to(dtype), mem_state, comp_state

    def exchange(self, payload: Payload, ctx: Ctx, compressor: Compressor
                 ) -> torch.Tensor:
        raise TypeError("ReduceScatterAllreduce re-shards the gradient "
                        "before compression; it only supports the full "
                        "step() pipeline, not a bare exchange().")
