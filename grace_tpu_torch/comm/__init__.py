"""Communicators over ``torch.distributed``; counterpart of the JAX
``comm/__init__.py`` (``Allreduce``, ``Allgather``, ``Broadcast`` and
``Identity``; the ring, two-shot, hierarchical, reduce-scatter and sign
communicators are queued in ROADMAP).

NCCL carries them on the card, gloo in the CPU tests. A world of one rank
still makes the real collective calls.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from grace_tpu_torch.core import (Communicator, Compressor, Ctx, Payload,
                                  mean_scale)

__all__ = ["Allreduce", "Allgather", "Broadcast", "Identity"]

# Newer PyTorch renames all_gather_into_tensor (same signature) and
# deprecates the old name.
_all_gather_into = (getattr(dist, "all_gather_single", None)
                    or dist.all_gather_into_tensor)


def _algebra(compressor) -> str | None:
    return getattr(compressor, "payload_algebra", None)


@dataclasses.dataclass(frozen=True)
class Allreduce(Communicator):
    """Sum payloads across ranks, divide by the world size if
    ``compressor.average``, then decompress once. Only for payloads that
    sum meaningfully (``summable_payload``).

    The sum is taken IN PLACE in the payload tensors: for the identity
    codec that is the gradient buffer itself, which the exchange consumes.
    """

    def exchange(self, payload: Payload, ctx: Ctx, compressor: Compressor
                 ) -> torch.Tensor:
        if getattr(compressor, "vote_aggregate", False):
            raise NotImplementedError(
                "the majority-vote Allreduce (signsgd/signum) comes with the "
                "quantized wire path (ROADMAP queue 1, slice B)")
        if not getattr(compressor, "summable_payload", False):
            raise TypeError(
                f"Allreduce requires a payload that sums meaningfully across "
                f"ranks; {type(compressor).__name__} does not declare "
                "summable_payload=True (its per-rank payloads decode "
                "differently, e.g. per-rank indices or norms). Use "
                "Allgather/Broadcast instead.")
        if _algebra(compressor) in ("shared_scale", "sketch"):
            raise NotImplementedError(
                "the homomorphic Allreduce (shared-scale and sketch "
                "payloads) comes with the homomorphic codecs (ROADMAP "
                "queue 1, slice C)")
        for t in payload:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        summed = tuple(payload)
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
    may do the decompress + aggregate + average in one kernel."""

    def exchange(self, payload: Payload, ctx: Ctx, compressor: Compressor
                 ) -> torch.Tensor:
        world = self.world_size()
        gathered = []
        for t in payload:
            t = t.contiguous()
            # Flat output buffer: gloo accepts no other shape, NCCL both.
            out = torch.empty(world * t.numel(), dtype=t.dtype,
                              device=t.device)
            _all_gather_into(out, t.reshape(-1), group=self.group)
            gathered.append(out.view((world,) + tuple(t.shape)))
        gathered = tuple(gathered)
        fused = getattr(compressor, "fused_aggregate_decompress", None)
        if fused is not None:
            out = fused(gathered, ctx, world)
            if out is not None:        # handles aggregate + average itself
                return out
        stacked = torch.stack([
            compressor.decompress(tuple(t[i] for t in gathered), ctx)
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
