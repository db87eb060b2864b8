"""The Compressor / Memory / Communicator pipeline over torch tensors.

Counterpart of the JAX package's ``core.py`` (its ``Compressor``, ``Memory``
and ``Communicator`` classes and ``Communicator.step``). The JAX version
threads every state functionally through ``jit``; here PyTorch runs eagerly,
so the same pipeline is plain Python over tensors. States are still
returned rather than hidden in objects, so the transform can hold them per
gradient leaf exactly as the JAX ``GraceState`` does.

Communicators exchange over a ``torch.distributed`` process group (``None``
= the default group) where the JAX package names a mesh axis.

The wire-byte model rides along: :class:`LinkBytes` and :class:`Topology`
describe which link class a rank's received bytes cross, and
``Communicator.recv_link_bytes`` / ``recv_wire_bytes`` price one step of
each schedule in pure integers, equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from grace_tpu_torch.telemetry.scopes import (STAGE_COMPENSATE,
                                              STAGE_COMPRESS, STAGE_EXCHANGE,
                                              STAGE_MEMORY_UPDATE,
                                              trace_stage)

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


# The tolerance of the wire model (Communicator.recv_wire_bytes) against
# the bytes counted from the collectives a step really issues, which the
# static auditor's wire reconciliation enforces (grace_tpu_torch.analysis):
# rtol covers per-shard rounding (packed bytes rounded up, per-shard top-k
# counts, per-chunk norms), atol the scalar bookkeeping collectives. The
# JAX package's values. Widening them to pass a drifted model defeats the
# audit: fix the model.
WIRE_MODEL_RTOL = 0.10
WIRE_MODEL_ATOL = 256


def needs_negotiation(compressor) -> bool:
    """Whether a communicator must run ``compressor.negotiate`` before the
    encode: every ``shared_scale`` codec, plus codecs that declare
    ``negotiates = True``."""
    return (getattr(compressor, "payload_algebra", None) == "shared_scale"
            or getattr(compressor, "negotiates", False))


def negotiation_bytes_for(compressor, n_elems: int, world: int) -> int:
    """Bytes one rank receives in one negotiation collective for an
    ``n_elems``-element compress call: the codec's leaf-aware
    ``negotiation_nbytes_for`` when it declares one, else the world-only
    ``negotiation_nbytes``."""
    fn = getattr(compressor, "negotiation_nbytes_for", None)
    if fn is not None:
        return int(fn(int(n_elems), world))
    return int(compressor.negotiation_nbytes(world))


# -- link classes and the layout of ranks ------------------------------------

class LinkBytes(NamedTuple):
    """One rank's received bytes split by the link class they arrive over,
    fastest first. The tier names are the JAX package's, which its params
    and tests use: on TPUs ``ici`` is the intra-slice interconnect, ``dcn``
    the data-center network between slices and ``wan`` the link between
    regions; on GPUs they mean NVLink within a node, the inter-node
    network, and the cross-region link. ``wan`` defaults to 0, so the
    two-tier ``LinkBytes(ici, dcn)`` is the same value with no WAN tier.
    The tiers sum to :meth:`Communicator.recv_wire_bytes`."""

    ici: int
    dcn: int
    wan: int = 0

    @property
    def total(self) -> int:
        return self.ici + self.dcn + self.wan

    @property
    def tiers(self) -> tuple:
        """The ordered ``(ici, dcn, wan)`` triple, fast link first."""
        return (self.ici, self.dcn, self.wan)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Which ranks share a fast link domain, and which a region.

    Ranks ``[k·slice_size, (k+1)·slice_size)`` form one slice (on GPUs: the
    ranks of one NVLink node); traffic between slices rides the inter-node
    network (``dcn``). ``slice_size=None`` means one slice spans any world:
    every byte is ``ici``. ``region_size`` (in ranks) adds the third tier:
    ranks ``[ρ·region_size, (ρ+1)·region_size)`` share a region, and
    traffic between regions rides ``wan``. It needs ``slice_size`` and must
    be a whole multiple of it: regions are made of whole slices.
    """

    slice_size: Optional[int] = None
    region_size: Optional[int] = None

    def __post_init__(self):
        if self.slice_size is not None and self.slice_size < 1:
            raise ValueError(f"slice_size must be >= 1 or None; "
                             f"got {self.slice_size}")
        if self.region_size is not None:
            if self.slice_size is None:
                raise ValueError(
                    "region_size requires slice_size — a region is a group "
                    "of whole ICI slices, so a 3-tier layout without a "
                    f"slice tier is contradictory (got region_size="
                    f"{self.region_size}, slice_size=None)")
            if (self.region_size < self.slice_size
                    or self.region_size % self.slice_size):
                raise ValueError(
                    f"region_size {self.region_size} must be a whole "
                    f"multiple of slice_size {self.slice_size} — regions "
                    "are made of whole slices (contiguous-block layout)")

    def crosses_dcn(self, world: int) -> bool:
        """True iff a flat collective over ``world`` ranks spans slices."""
        return self.slice_size is not None and world > self.slice_size

    def crosses_wan(self, world: int) -> bool:
        """True iff a flat collective over ``world`` ranks spans regions."""
        return self.region_size is not None and world > self.region_size

    def flat_tier(self, world: int) -> str:
        """The tier a flat collective over ``world`` ranks is priced at:
        the slowest boundary it spans (``'wan'``, ``'dcn'`` or ``'ici'``),
        since some rank's incoming link crosses it and the collective ends
        when that rank does."""
        if self.crosses_wan(world):
            return "wan"
        if self.crosses_dcn(world):
            return "dcn"
        return "ici"

    def shrink(self, world: int, lost_ranks) -> Tuple["Topology", int]:
        """``(topology, new_world)`` after ``lost_ranks`` leave a world of
        ``world`` ranks. Whole regions lost keep both tiers (down to the
        two-tier layout when one region remains); whole slices lost keep
        the slice tier; a partial slice lost leaves the flat layout."""
        lost = set(int(r) for r in lost_ranks)
        if not lost:
            return self, world
        bad = [r for r in lost if r < 0 or r >= world]
        if bad:
            raise ValueError(f"lost_ranks {sorted(bad)} outside the world "
                             f"[0, {world})")
        new_world = world - len(lost)
        if new_world < 1:
            raise ValueError(f"cannot shrink world {world} by "
                             f"{len(lost)} ranks — no survivors")
        if self.slice_size is None:
            return Topology(), new_world
        s = self.slice_size
        if world % s:
            raise ValueError(f"world {world} is not a multiple of "
                             f"slice_size {s} — this topology never "
                             "described that world")
        whole = all(
            all(k * s + i in lost for i in range(s))
            for k in sorted({r // s for r in lost}))
        if not whole:
            return Topology(), new_world
        if self.region_size is None:
            return Topology(slice_size=s), new_world
        rz = self.region_size
        if world % rz:
            raise ValueError(f"world {world} is not a multiple of "
                             f"region_size {rz} — this topology never "
                             "described that world")
        touched = sorted({r // rz for r in lost})
        whole_regions = all(
            all(rho * rz + i in lost for i in range(rz)) for rho in touched)
        if not whole_regions:
            # Slices survive whole, but the regions are no longer equal.
            return Topology(slice_size=s), new_world
        if world // rz - len(touched) <= 1:
            # One region remains: the WAN tier is vacuous.
            return Topology(slice_size=s), new_world
        return Topology(slice_size=s, region_size=rz), new_world

    @classmethod
    def detect(cls, devices=None, group=None) -> "Topology":
        """The layout of ``devices`` or of a process group.

        Given a list, it groups by each entry's ``slice_index`` and
        ``region_index`` attributes (``None`` or missing counts as absent)
        and raises where no contiguous-block layout describes them: some
        entries exposing an index and some not, uneven groups, a region
        tier without a slice tier, or regions that are not whole multiples
        of the slice width. An empty list is one slice.

        With ``None`` it reads ``group`` (None: the default process group):
        one slice per host, from every rank's host name
        (``dist.all_gather_object``, a collective every rank of the group
        must join), and no region tier. With no initialised process group
        it is one slice.
        """
        if devices is None:
            return cls._detect_hosts(group)
        devices = list(devices)

        def group_counts(attr):
            counts: dict = {}
            missing = 0
            for d in devices:
                idx = getattr(d, attr, None)
                if idx is None:
                    missing += 1
                else:
                    counts[idx] = counts.get(idx, 0) + 1
            if counts and missing:
                raise ValueError(
                    f"cannot detect topology: {missing} of {len(devices)} "
                    f"devices expose no {attr} while "
                    f"{len(devices) - missing} do — a heterogeneous device "
                    "list (mixed runtimes / stale handles?) has no "
                    "consistent layout. Pass an explicit Topology(...) "
                    "instead.")
            return counts

        def uniform_size(counts, noun):
            sizes = sorted(set(counts.values()))
            if len(sizes) > 1:
                raise ValueError(
                    f"cannot detect topology: {noun}s are uneven — "
                    f"per-{noun} device counts "
                    f"{dict(sorted(counts.items()))} — so no single "
                    f"{noun}_size describes the layout (the wire model "
                    "assumes contiguous equal blocks). Pass an explicit "
                    "Topology(...) for the layout you mean.")
            return sizes[0]

        slice_counts = group_counts("slice_index")
        region_counts = group_counts("region_index")
        slice_size = (uniform_size(slice_counts, "slice")
                      if len(slice_counts) > 1 else None)
        region_size = (uniform_size(region_counts, "region")
                       if len(region_counts) > 1 else None)
        if region_size is not None and slice_size is None:
            raise ValueError(
                "cannot detect topology: devices expose region_index "
                f"({len(region_counts)} regions) but no multi-slice "
                "slice_index layout — a region tier without a slice tier "
                "is contradictory (regions are groups of whole ICI "
                "slices). Pass an explicit Topology(...) instead.")
        if (region_size is not None
                and (region_size < slice_size or region_size % slice_size)):
            raise ValueError(
                f"cannot detect topology: per-region device count "
                f"{region_size} is not a whole multiple of the slice "
                f"width {slice_size} — a slice straddles a region "
                "boundary, which the contiguous-block layout cannot "
                "describe. Pass an explicit Topology(...) for the layout "
                "you mean.")
        if slice_size is None:
            return cls()
        return cls(slice_size=slice_size, region_size=region_size)

    @classmethod
    def _detect_hosts(cls, group=None) -> "Topology":
        """One slice per host of ``group`` (None: the default process
        group), in rank order; a host whose ranks are not one contiguous
        block raises."""
        if not (dist.is_available() and dist.is_initialized()):
            return cls()
        import socket
        hosts = [None] * dist.get_world_size(group)
        dist.all_gather_object(hosts, socket.gethostname(), group=group)
        order = list(dict.fromkeys(hosts))
        index = [order.index(h) for h in hosts]
        if any(b < a for a, b in zip(index, index[1:])):
            raise ValueError(
                f"cannot detect topology: the ranks of a host are not one "
                f"contiguous block (hosts by rank: {hosts}), which the "
                "contiguous-block layout cannot describe. Pass an explicit "
                "Topology(...) for the layout you mean.")
        return cls.detect([types.SimpleNamespace(slice_index=i)
                           for i in index])


SINGLE_SLICE = Topology()


# -- the per-(step, leaf) generator contract ---------------------------------

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


# The static auditor's recorder of the trace in progress (analysis.trace
# sets and clears it), else None: LeafKey notes each draw on it.
DRAW_RECORDER = None

# The state fields the transform's step keys are read from.
STEP_KEY_FIELDS = ("seed", "count")


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
    :meth:`split` is ``fold`` over ``range(n)``; the grouped executor keys
    a group's rows with it (``leaf`` is then the group's index).
    :meth:`seed_int32` is the counterpart of ``jax.random.randint(key, (),
    0, 2**31 - 1, int32)``: a host-side seed for the kernels' counter hash.

    ``fields`` names the state fields ``seed`` and ``count`` were read
    from (the transform's step keys: ``STEP_KEY_FIELDS``); empty for a key
    built from constants. It takes no part in the stream or in equality:
    the static auditor reads it as the draw's lineage root. While the
    auditor records a trace, every consumption of a key (each method
    below but :meth:`fold` and :meth:`split`) is noted on its recorder
    (:data:`DRAW_RECORDER`); otherwise that costs one module-level check.
    """

    seed: int
    count: int
    leaf: int
    folds: Tuple[int, ...] = ()
    fields: Tuple[str, ...] = dataclasses.field(default=(), compare=False)

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

    def _note(self, method: str, shape, dtype: str) -> None:
        rec = DRAW_RECORDER
        if rec is not None:
            rec.draw(self, method, tuple(shape), dtype)

    def seed_int32(self) -> int:
        """A seed in ``[0, 2**31 - 1)``, drawn on the host from this key."""
        self._note("seed_int32", (), "int32")
        return self.derived_seed() % (2**31 - 1)

    def _generator(self, device) -> torch.Generator:
        gen = torch.Generator(device=device)
        gen.manual_seed(self.derived_seed())
        return gen

    def generator(self, device) -> torch.Generator:
        """A fresh generator on ``device`` seeded by the contract above."""
        self._note("generator", (), "generator")
        return self._generator(device)

    def uniform(self, shape, device) -> torch.Tensor:
        """Float32 uniforms in ``[0, 1)`` from this key's stream: the one
        place the staged stochastic codecs draw their noise (the
        counterpart of ``jax.random.uniform(key, shape)``)."""
        self._note("uniform", shape, "float32")
        return torch.rand(shape, generator=self._generator(device),
                          device=device, dtype=torch.float32)

    def permutation(self, n: int, device) -> torch.Tensor:
        """A permutation of ``range(n)`` (int64) from this key's stream,
        the same on every rank for the same key (the counterpart of
        ``jax.random.permutation(key, n)``, whose bits differ)."""
        self._note("permutation", (n,), "int64")
        return torch.randperm(n, generator=self._generator(device),
                              device=device)

    def randint(self, shape, low: int, high: int, device) -> torch.Tensor:
        """Int32 integers in ``[low, high)`` from this key's stream (the
        counterpart of ``jax.random.randint(key, shape, low, high)``,
        whose bits differ)."""
        self._note("randint", shape, "int32")
        return torch.randint(low, high, tuple(shape),
                             generator=self._generator(device), device=device,
                             dtype=torch.int32)

    def normal(self, shape, device) -> torch.Tensor:
        """Float32 standard normals from this key's stream (the
        counterpart of ``jax.random.normal(key, shape)``, whose bits
        differ)."""
        self._note("normal", shape, "float32")
        return torch.randn(tuple(shape), generator=self._generator(device),
                           device=device, dtype=torch.float32)

    def split(self, n: int = 2) -> Tuple["LeafKey", ...]:
        """``n`` independent sub-keys, ``fold(0)`` to ``fold(n - 1)`` (the
        counterpart of ``jax.random.split(key, n)``). ``fusion='grouped'``
        gives row ``j`` of group ``g`` the key ``LeafKey(seed, count,
        g).split(G)[j]``, where JAX gives it ``split(fold_in(step_key, g),
        G)[j]``."""
        return tuple(self.fold(i) for i in range(n))


_HALF = (torch.float16, torch.bfloat16)


def _sum_rows(t: torch.Tensor) -> torch.Tensor:
    """``0 + t[0] + t[1] + ...`` in ``t``'s dtype, one rounding an add (a
    sum of -0.0 rows is +0.0, as in XLA's reduction)."""
    out = torch.zeros_like(t[0])
    for row in t:
        out += row
    return out


# -- the three roles ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Compressor:
    """Lossy gradient codec.

    Capability flags, as in the JAX package:

    * ``average`` — divide the aggregate by the world size.
    * ``tensors_size_are_same`` — kept for parity with the JAX package,
      where it documents the reference's variable-size payloads (dgc,
      threshold, adaq, inceptionn set it False). Every payload here has a
      shape that depends only on the input's shape, so no communicator
      reads it.
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
    tensors_size_are_same = True
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

    def wire_nbytes(self, shape, dtype) -> Optional[int]:
        """Analytic wire bytes of one tensor's payload, or None to let
        :func:`grace_tpu_torch.utils.metrics.payload_nbytes` encode zeros of
        that shape and count them."""
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
        reduce-scatter's owned-chunk sum, the hierarchical boundary sums),
        in the payload's own dtype: ``torch.sum`` would widen int16 to
        int64, and the accumulator width is what
        :meth:`payload_sum_max_world` bounds. Half-precision payloads add
        row by row, rounding after each add as XLA's reduction does:
        ``torch.sum`` keeps a float32 accumulator and rounds once, which
        differs in the last bit from three rows on."""
        return tuple(_sum_rows(t) if t.dtype in _HALF
                     else torch.sum(t, dim=0, dtype=t.dtype)
                     for t in stacked)

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

    # True for the communicators that re-chunk the gradient into per-rank
    # shards inside ``step`` (two-shot, ring, reduce-scatter, hier).
    shard_parallel = False

    def world_size(self) -> int:
        return dist.get_world_size(self.group)

    def shard_spec(self, n: int) -> tuple[int, int, int]:
        """Equal-shard split of an ``n``-element flat buffer over the group:
        ``(world, shard_elems, pad)`` with ``world * shard_elems == n +
        pad``, the chunk schedule of the shard-parallel communicators."""
        w = self.world_size()
        pad = (-n) % w
        return w, (n + pad) // w, pad

    # -- the wire-byte model: pure integers, equal to the JAX package's -----

    def _recv_total_bytes(self, payload_nbytes: int, n_elems: int,
                          world: int, vote: bool = False) -> int:
        """Bytes one rank receives in one step at ``world`` ranks, the
        per-communicator formula that :meth:`recv_link_bytes` splits.
        Default: gather-style, every other rank's payload arrives."""
        return payload_nbytes * max(0, world - 1)

    def recv_link_bytes(self, payload_nbytes: int, n_elems: int, world: int,
                        topology: Optional[Topology] = None,
                        vote: bool = False) -> LinkBytes:
        """One rank's received bytes split by link class. A flat schedule
        is priced whole at the slowest boundary its group spans
        (:meth:`Topology.flat_tier`): some rank's incoming link crosses it,
        and the collective ends when that rank does. ``topology=None`` is
        :data:`SINGLE_SLICE`. The hierarchical communicator overrides this
        with a mixed split."""
        total = int(self._recv_total_bytes(payload_nbytes, n_elems, world,
                                           vote=vote))
        topo = topology if topology is not None else SINGLE_SLICE
        tier = topo.flat_tier(world)
        if tier == "wan":
            return LinkBytes(ici=0, dcn=0, wan=total)
        if tier == "dcn":
            return LinkBytes(ici=0, dcn=total)
        return LinkBytes(ici=total, dcn=0)

    def recv_wire_bytes(self, payload_nbytes: int, n_elems: int, world: int,
                        vote: bool = False) -> int:
        """Logical bytes one rank receives a step at ``world`` ranks:
        ``payload_nbytes`` is one rank's whole payload
        (:func:`grace_tpu_torch.utils.metrics.payload_nbytes`), ``n_elems``
        the dense element count (a vote moves dense votes), ``vote``
        whether the exchange takes a majority-vote route. The sum of
        :meth:`recv_link_bytes`' tiers."""
        return self.recv_link_bytes(payload_nbytes, n_elems, world,
                                    vote=vote).total

    def wire_overlap_fraction(self) -> float:
        """Share of the wire time the schedule can hide behind its own
        compute: 0.0 for a serial schedule; the pipelined ring and hier
        schedules override it."""
        return 0.0

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

    def step_rows(self, xs: Sequence[torch.Tensor],
                  mem_states: Sequence[State], comp_states: Sequence[State],
                  memory: Memory, compressor: Compressor,
                  rngs: Sequence[LeafKey]) -> tuple[list, list, list]:
        """``fusion='grouped'``'s pipeline over the rows of one group, G
        leaves of one shape and dtype: each row encoded as :meth:`step`
        encodes it, then the G payloads exchanged together
        (:meth:`exchange_rows`). Every row's result is the one its own
        :meth:`step` gives."""
        encoded = [self.encode(x, ms, cs, memory, compressor, rng)
                   for x, ms, cs, rng in zip(xs, mem_states, comp_states,
                                             rngs)]
        outs = self.exchange_rows([e[0] for e in encoded],
                                  [e[1] for e in encoded], compressor)
        return outs, [e[2] for e in encoded], [e[3] for e in encoded]

    def exchange_rows(self, payloads: Sequence[Payload], ctxs: Sequence[Ctx],
                      compressor: Compressor) -> list:
        """:meth:`exchange` of G rows' payloads, equal row for row to G
        calls of it. The default makes those G calls; the exchange-based
        communicators stack the rows and make one collective a payload
        tensor."""
        return [self.exchange(p, c, compressor)
                for p, c in zip(payloads, ctxs)]

    def step(self, x: torch.Tensor, mem_state: State, comp_state: State,
             memory: Memory, compressor: Compressor, rng: LeafKey
             ) -> tuple[torch.Tensor, State, State]:
        """compensate → compress → memory update → exchange, each stage a
        named trace span (``telemetry.scopes``)."""
        payload, ctx, mem_state, comp_state = self.encode(
            x, mem_state, comp_state, memory, compressor, rng)
        with trace_stage(STAGE_EXCHANGE):
            out = self.exchange(payload, ctx, compressor)
        return out, mem_state, comp_state

    def encode(self, x: torch.Tensor, mem_state: State, comp_state: State,
               memory: Memory, compressor: Compressor, rng: LeafKey
               ) -> tuple[Payload, Ctx, State, State]:
        """The local half of :meth:`step`: compensate → compress → memory
        update, ``(payload, ctx, mem_state, comp_state)``.

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
            with trace_stage(STAGE_COMPRESS):
                fused_out = fused(x, mem_state, coeffs, rng)
            if fused_out is not None:
                payload, ctx, mem_state = fused_out
                return payload, ctx, mem_state, comp_state
        with trace_stage(STAGE_COMPENSATE):
            compensated, mem_state = memory.compensate(x, mem_state)
        # The negotiation runs before the encode, on the compensated
        # tensor: the shared value (and so the decode ctx) is the same on
        # every rank, payloads sum homomorphically, and error feedback
        # covers the one negotiated encode. A process group always exists
        # here, a one-rank one included, so it always runs.
        shared = None
        if needs_negotiation(compressor):
            with trace_stage(f"{STAGE_EXCHANGE}/negotiate_scale"):
                shared = compressor.negotiate(compensated, self.group,
                                              rng=rng)
        with trace_stage(STAGE_COMPRESS):
            if shared is None:
                payload, ctx, comp_state = compressor.compress(
                    compensated, comp_state, rng)
            else:
                payload, ctx, comp_state = compressor.compress(
                    compensated, comp_state, rng, shared=shared)
        with trace_stage(STAGE_MEMORY_UPDATE):
            mem_state = memory.update(compensated, payload, ctx, compressor,
                                      mem_state)
        return payload, ctx, mem_state, comp_state
