"""The GRACE executors over a model's gradients.

Counterpart of the JAX package's ``grace_transform``, its ``GraceState``,
its fusion plans and its per-leaf codec routes. The optax
``GradientTransformation`` becomes an object with ``init(params)`` and
``update(grads, state)``; the torch optimizer then applies the returned
updates. Four executors, as in JAX:

* ``fusion=None``: one pipeline per leaf (``communicator.step_leaves``:
  each leaf's ``step`` with its states and stream, grouped where the
  communicator and codec allow). With ``routes``, each leaf runs through
  the triad its path matches.
* ``fusion='grouped'``: the leaves of one (shape, dtype) form a group
  (:func:`_group_views`); ``communicator.step_rows`` runs the group's rows,
  each with per-leaf semantics, and exchanges their G payloads stacked, one
  collective a payload tensor, where JAX vmaps ``communicator.step`` over
  the stack. State per group is stacked along a leading axis of G.
* ``fusion=<int bytes>``: whole leaves packed greedily into buckets of at
  most that many bytes at their common dtype (:func:`_bucketize`), one
  independent pipeline a bucket, the K bucket buffers handed to
  ``communicator.step_leaves`` as K leaves. State per bucket.
* ``fusion='flat'``: the bucketed executor with one bucket.

Gradients and parameters are flat mappings from dotted names
(``"s0b0.conv1.w"``, as ``nn.Module.named_parameters`` gives them) to
tensors. Leaves are walked in the JAX flatten order of the same parameter
tree: sorted keys at every level of the path, list indices in index order
(:func:`leaf_order`). Per-leaf chunk Top-K selects
over each leaf's flat order, so the two packages pick the same elements
only when they walk the same leaves in the same order with the same
layouts. :func:`leaf_path_str` spells a dotted name as JAX spells the
leaf's tree path (``"s0b0/conv1/w"``), so one route table matches the same
leaves in both packages.

Random streams: leaf ``i`` at step ``count`` gets
``LeafKey(seed, count, i)`` (see :class:`grace_tpu_torch.core.LeafKey`),
the counterpart of ``fold_in(fold_in(key(seed), count), i)``; bucket ``b``
gets ``LeafKey(seed, count, b)``; row ``j`` of group ``g`` gets
``LeafKey(seed, count, g).split(G)[j]``, JAX's ``split(fold_in(step_key,
g), G)[j]``.

Every rank walks the same plan (it reads names, shapes and dtypes only), so
the collectives of the buckets, groups and routed triads line up.

Three options ride on every executor, as in JAX:

* ``escape=`` a dense codec (none, fp16, bf16): while the state's replicated
  ``fallback`` flag is set, the update is a dense ``escape``-coded
  all-reduce of the raw gradients instead, leaf by leaf, and ``mem`` and
  ``comp`` pass through untouched. The flag is set by
  :func:`grace_tpu_torch.resilience.guard_transform`; JAX branches with
  ``lax.cond`` on it, the port reads it on the host where the exchange
  begins (the guard makes it known there).
* ``telemetry=``: one row of the device ring
  (:mod:`grace_tpu_torch.telemetry`) at the end of each update: the norms,
  the relative compression error (a compress → decompress round-trip over
  the structures the executor compresses, without feedback), and the
  effective wire bytes under the transform's :class:`Topology`, which flip
  to the escape's price inside a fallback window.
* ``watch=`` (with telemetry): every ``window``-th update gathers each
  rank's gradient norm, compression error and residual norm, and writes
  the cross-rank summary into ``GraceState.watch``
  (:mod:`grace_tpu_torch.telemetry.aggregate`); the gather's bytes ride in
  the row's ``wire_bytes`` as ``watch_bytes``.

``consensus=`` makes the state carry an :class:`AuditState`, which the
train step's consistency audit advances
(:mod:`grace_tpu_torch.resilience.consensus`).

``adapt=`` (with ``escape`` and ``telemetry``) arms the adaptive ladder
(:mod:`grace_tpu_torch.resilience.adapt`): each update runs one rung, the
dense escape at rung 0 (forced while ``fallback`` is set) or the rung's
codec through the unchanged memory, communicator and executor above it; the
row prices the step at that rung, and the rung's relative compression
error feeds the controller, whose state rides in ``GraceState.adapt``.

State surgery: :func:`carry_replicated` grafts an old state's replicated
fields onto a fresh init (an elastic world resize), and
:func:`migrate_grace_state` moves a state across configurations at one
world (residuals and compressor state carried where their layouts agree).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import functools
import math
from typing import (Dict, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch

from grace_tpu_torch.core import (STEP_KEY_FIELDS, Communicator,
                                  Compressor, LeafKey, LinkBytes, Memory,
                                  State, Topology, negotiation_bytes_for)
from grace_tpu_torch.telemetry.aggregate import (WatchConfig, WatchState,
                                                 normalize_watch,
                                                 watch_gather_bytes,
                                                 watch_init, watch_record)
from grace_tpu_torch.telemetry.scopes import (STAGE_ADAPT, STAGE_BUCKET,
                                              STAGE_DENSE_ESCAPE,
                                              STAGE_TELEMETRY, STAGE_WATCH,
                                              trace_stage)
from grace_tpu_torch.telemetry.state import (TelemetryConfig,
                                             TelemetryState, telemetry_init,
                                             telemetry_record)

Fusion = Union[None, str, int]


def _part_key(part: str):
    # A part of decimal digits is a list index (an ``nn.ModuleList`` or
    # ``nn.Sequential`` index in the port), which JAX flattens in index
    # order; any other part is a dict key, which JAX sorts as a string.
    # Digit parts go first, as they would among strings.
    return (0, int(part)) if part.isdecimal() else (1, part)


def leaf_order(names) -> List[str]:
    """``names`` in the JAX flatten order of the nested tree they spell:
    dict keys sorted as strings (``conv10`` before ``conv2``), list
    indices as integers (``layers.2`` before ``layers.10``)."""
    return sorted(names, key=lambda name: tuple(
        _part_key(p) for p in name.split(".")))


def leaf_path_str(name: str) -> str:
    """The JAX package's ``"/"``-joined tree path of the leaf named
    ``name`` (``"s0b0.conv1.w"`` → ``"s0b0/conv1/w"``): the string route
    patterns match against."""
    return name.replace(".", "/")


def common_dtype(tensors) -> torch.dtype:
    """The dtype every tensor promotes to (the flat buffer's dtype)."""
    return functools.reduce(torch.promote_types, (t.dtype for t in tensors))


# -- the mesh ------------------------------------------------------------------

DEFAULT_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """The transform's view of the mesh: a data-parallel axis plus an
    optional FSDP (sharded-model) axis; the JAX package's ``MeshSpec``.

    Pure data parallelism is the 1-axis case (``fsdp_axis=None``). With
    ``fsdp_axis`` set, the ranks form a 2-D ``dp×fsdp`` mesh:

    * each rank's model holds its **shard** of every sharded parameter
      (``train.make_train_step(param_specs=...)`` says which dimension; a
      replicated parameter is whole on every rank), and its optimizer and
      GraceState are initialised on those local shards;
    * the gradient a rank hands the transform is its per-shard gradient,
      and the compressed exchange is the per-shard reduce over the rank's
      **dp group** (the ranks that share its fsdp index): the
      communicator's group must be that group;
    * the per-rank GraceState fields (``mem``, ``comp``, ``telem``,
      ``watch``) of a rank cover its own parameter shard: residuals live on
      the shard owner. The JAX package spells this as a leading world axis
      over the dp×fsdp product (``varying_spec``: ``P((dp, fsdp))``, one
      row per device); the port has no such axis, since each process holds
      its own rank's state, and JAX's row ``r`` is rank ``r``'s state;
    * the replicated fields (``count``, ``seed``, ``fallback``, ``audit``,
      ``adapt``) stay bit-identical across both axes, which lets the
      consensus audit compare replicas per fsdp shard over the dp group.

    The process-group view is bound by :func:`grace_tpu_torch.parallel.
    make_mesh`: ``group`` (the whole mesh), this rank's ``dp_group`` and
    ``fsdp_group``, the mesh ``shape`` and this rank's indices. Rank ``r``
    of the mesh sits at dp index ``r // fsdp`` and fsdp index ``r % fsdp``,
    as ``jax.make_mesh((dp, fsdp))`` lays out devices. A spec built by hand
    names the axes only (``bound`` is False): its groups are the default
    process group's."""

    dp_axis: str = DEFAULT_AXIS
    fsdp_axis: Optional[str] = None
    # The process-group view (parallel.make_mesh); not part of equality.
    shape: Optional[Tuple[int, ...]] = dataclasses.field(
        default=None, compare=False)
    group: Optional[object] = dataclasses.field(default=None, compare=False)
    dp_group: Optional[object] = dataclasses.field(default=None,
                                                   compare=False)
    fsdp_group: Optional[object] = dataclasses.field(default=None,
                                                     compare=False)
    dp_index: int = dataclasses.field(default=0, compare=False)
    fsdp_index: int = dataclasses.field(default=0, compare=False)

    def __post_init__(self):
        if self.fsdp_axis is not None and self.fsdp_axis == self.dp_axis:
            raise ValueError(
                f"fsdp_axis must differ from dp_axis; both are "
                f"{self.dp_axis!r}")

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axis names, dp first."""
        if self.fsdp_axis is None:
            return (self.dp_axis,)
        return (self.dp_axis, self.fsdp_axis)

    @property
    def is_2d(self) -> bool:
        return self.fsdp_axis is not None

    @property
    def bound(self) -> bool:
        """True when :func:`~grace_tpu_torch.parallel.make_mesh` built it
        (it carries process groups)."""
        return self.shape is not None

    @property
    def dp_size(self) -> int:
        return self.shape[0] if self.bound else 1

    @property
    def fsdp_size(self) -> int:
        return self.shape[1] if self.bound and len(self.shape) > 1 else 1

    def local_shard(self, t: torch.Tensor, dim: Optional[int]
                    ) -> torch.Tensor:
        """This rank's fsdp shard of the whole tensor ``t`` split evenly
        on ``dim`` (JAX's ``P(..., "fsdp", ...)`` at that dimension); ``t``
        itself for ``dim=None`` (replicated)."""
        if dim is None:
            return t
        n = self.fsdp_size
        if t.shape[dim] % n:
            raise ValueError(
                f"dimension {dim} of size {t.shape[dim]} does not split "
                f"evenly over the fsdp axis of size {n}")
        size = t.shape[dim] // n
        return t.narrow(dim, self.fsdp_index * size, size)

    def dp_rows(self, batch):
        """This rank's rows of a global batch (a tensor or a tuple/list of
        them, split on dim 0 over the dp axis only): both fsdp shards of a
        dp row see the same rows, as JAX's ``P(dp)`` batch spec gives."""
        if isinstance(batch, (tuple, list)):
            return type(batch)(self.dp_rows(b) for b in batch)
        n = self.dp_size
        if batch.shape[0] % n:
            raise ValueError(f"batch of {batch.shape[0]} rows does not "
                             f"split over {n} dp ranks")
        size = batch.shape[0] // n
        return batch[self.dp_index * size:(self.dp_index + 1) * size]

    @classmethod
    def normalize(cls, spec) -> "MeshSpec":
        """Accept the ergonomic spellings: an axis-name string (pure dp),
        a MeshSpec, or None (the default axis)."""
        if spec is None:
            return cls()
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            return cls(dp_axis=spec)
        raise TypeError(f"mesh must be an axis-name str or MeshSpec; got "
                        f"{type(spec).__name__}")


# -- fusion plans: plain functions over (shape, dtype) -----------------------

def _struct(leaf) -> Tuple[Tuple[int, ...], torch.dtype]:
    """A tensor or a ``(shape, dtype)`` pair as ``(shape, dtype)``."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype
    shape, dtype = leaf
    return tuple(shape), dtype


def _bucketize(shapes_dtypes, bucket_bytes: Optional[int]):
    """Leaf indices grouped into fusion buckets of at most ``bucket_bytes``
    at the leaves' common dtype (whole leaves only; an oversized leaf gets
    its own bucket); ``None`` means one bucket for everything. An empty
    leaf list gives no buckets. Returns ``(buckets, common_dtype)``, equal
    to the JAX package's plan."""
    n = len(shapes_dtypes)
    cdtype = (functools.reduce(torch.promote_types,
                               (d for _, d in shapes_dtypes))
              if shapes_dtypes else torch.float32)
    if bucket_bytes is None:
        return ([list(range(n))] if n else []), cdtype
    itemsize = cdtype.itemsize
    buckets, cur, cur_bytes = [], [], 0
    for i, (shape, _) in enumerate(shapes_dtypes):
        nbytes = math.prod(shape) * itemsize
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets, cdtype


def _group_views(leaves) -> List[List[int]]:
    """The grouped plan: leaf indices keyed by (shape, dtype), in order of
    first appearance."""
    groups: dict = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault(_struct(leaf), []).append(i)
    return list(groups.values())


def _bucket_bytes(fusion: Fusion) -> Optional[int]:
    return None if fusion == "flat" else int(fusion)


def fusion_payload_structs(leaves, fusion: Fusion) -> list:
    """``[((shape, dtype), multiplicity), ...]``: the tensors the fusion
    mode hands the codec, one entry a distinct compress call. Per leaf:
    every leaf, ×1; ``'grouped'``: one leaf a group, ×its size; ``'flat'``
    and byte buckets: one flat buffer a bucket at the common dtype, ×1."""
    structs = [_struct(l) for l in leaves]
    if fusion == "grouped":
        return [(structs[idxs[0]], len(idxs))
                for idxs in _group_views(structs)]
    if fusion is None:
        return [(s, 1) for s in structs]
    buckets, cdtype = _bucketize(structs, _bucket_bytes(fusion))
    return [(((sum(math.prod(structs[i][0]) for i in idxs),), cdtype), 1)
            for idxs in buckets]


def fusion_payload_nbytes(compressor: Compressor, leaves, fusion: Fusion
                          ) -> Tuple[int, int, int]:
    """``(dense_bytes, payload_bytes, n_elems)`` of these leaves under a
    fusion setting: the raw dense size, one rank's whole wire payload
    priced over :func:`fusion_payload_structs` by
    :func:`grace_tpu_torch.utils.metrics.payload_nbytes`, and the element
    count. Equal to the JAX package's integers."""
    from grace_tpu_torch.utils.metrics import payload_nbytes

    structs = [_struct(l) for l in leaves]
    n_elems = sum(math.prod(s) for s, _ in structs)
    dense = sum(math.prod(s) * d.itemsize for s, d in structs)
    comp_b = sum(payload_nbytes(compressor, s) * count
                 for s, count in fusion_payload_structs(structs, fusion))
    return dense, comp_b, n_elems


# -- per-leaf routes ----------------------------------------------------------

def normalize_routes(routes, base_communicator: Communicator) -> Tuple:
    """A per-leaf routing table as ``((pattern, compressor, memory,
    communicator), ...)``. Each entry is ``(pattern, triad)``: an
    ``fnmatch`` glob over the leaf's ``"/"``-joined path, and a 3-tuple
    ``(compressor, memory, communicator)`` or an object with those
    attributes (a :class:`grace_tpu_torch.helper.Grace`). First match wins;
    unmatched leaves ride the base triad. Every route's communicator must
    run over the base one's process group, where JAX compares the mesh
    axis: the routed exchanges all rendezvous on one group."""
    out = []
    for entry in routes:
        if len(entry) == 4:                 # already normalized
            pat, comp, mem, cm = entry
        else:
            pat, triad = entry
            if isinstance(triad, (tuple, list)):
                if len(triad) != 3:
                    raise ValueError(
                        f"route {pat!r}: triad must be (compressor, "
                        f"memory, communicator); got {len(triad)} "
                        "elements")
                comp, mem, cm = triad
            else:
                comp, mem, cm = (triad.compressor, triad.memory,
                                 triad.communicator)
        if cm.group != base_communicator.group:
            raise ValueError(
                f"route {pat!r}: communicator group {cm.group!r} differs "
                f"from the base communicator's {base_communicator.group!r} "
                "— all routed exchanges must rendezvous on one process "
                "group")
        out.append((str(pat), comp, mem, cm))
    return tuple(out)


def route_for(routes, path_str: str, default):
    """The ``(compressor, memory, communicator)`` triad of one leaf path:
    the first route whose pattern matches, else ``default``."""
    for pat, comp, mem, cm in routes:
        if fnmatch.fnmatchcase(path_str, pat):
            return comp, mem, cm
    return default


# -- grouped state: one state a row, stacked along a leading axis ------------

def _stack_states(states):
    """G rows' states as one: None stays None, tensors stack, dicts (the
    DGC memory's, Signum's) stack entry by entry."""
    first = states[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack_states([s[k] for s in states]) for k in first}
    return torch.stack(states)


def _unstack_state(state, g: int) -> list:
    if state is None:
        return [None] * g
    if isinstance(state, dict):
        parts = {k: _unstack_state(v, g) for k, v in state.items()}
        return [{k: parts[k][j] for k in state} for j in range(g)]
    return list(state.unbind(0))


def _state_tensors(state) -> list:
    """The tensors of a mem/comp entry, or of a list of them (None, a
    tensor, or dicts, tuples and lists of them), in a fixed order."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, (dict, tuple, list)):
        values = state.values() if isinstance(state, dict) else state
        return [t for v in values for t in _state_tensors(v)]
    return []


def _float32(tensors) -> list:
    """The floating tensors among ``tensors`` as float32, empty ones left
    out."""
    return [t if t.dtype == torch.float32 else t.float() for t in tensors
            if t.is_floating_point() and t.numel()]


def _sqsum(tensors) -> torch.Tensor:
    """Σ x² over every floating tensor, in float32, as a 0-d tensor on
    their device (the JAX package's ``_sqsum``; the per-tensor norms run
    as one multi-tensor launch, and the sum is squared norms, equal to
    JAX's within float32 rounding)."""
    ts = _float32(tensors)
    if not ts:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack(torch._foreach_norm(ts)).square().sum()


def _absmax(tensors) -> torch.Tensor:
    """max |x| over every floating tensor (NaN if any is NaN)."""
    return torch.stack(torch._foreach_norm(_float32(tensors),
                                           float("inf"))).amax()


_REINIT = ("the state was built under a different fusion setting. Re-init "
           "the optimizer state (or restore a checkpoint written with the "
           "same fusion config).")


def _step_key(state: "GraceState", i: int) -> LeafKey:
    """Position ``i``'s random stream at this step: the state's ``seed``
    and ``count``, named in the key for the static auditor."""
    return LeafKey(state.seed, state.count, i, fields=STEP_KEY_FIELDS)


class AuditState(NamedTuple):
    """The consistency auditor's bookkeeping
    (:mod:`grace_tpu_torch.resilience.consensus`), the JAX package's
    fields. Replicated, and held on the host: every field follows from the
    fingerprint matrix that each rank reads at an audit, so every rank
    computes the same values without a device read of its own."""

    audits: int = 0                # audits performed
    repairs: int = 0               # repairs (a divergence on any rank)
    escalations: int = 0           # repeat-offender dense-window trips
    last_divergent_rank: int = -1  # group rank of the last divergence
    last_repair_step: int = -1     # GraceState.count at the last repair


def audit_init() -> AuditState:
    return AuditState()


@dataclasses.dataclass
class GraceState:
    count: int                # step counter, the same on every rank
    seed: int                 # base of the per-(step, leaf) streams
    mem: List[State]          # memory state per leaf, group or bucket
    comp: List[State]         # compressor state likewise
    # Replicated health flag: True routes the next update through the
    # dense escape (grace_transform(escape=...)). Written by the guard via
    # set_fallback_flag (and by the consensus audit's escalation); without
    # either it stays False.
    fallback: bool = False
    # The telemetry ring (per-rank data, like mem/comp) when the transform
    # was built with telemetry=..., else None.
    telem: Optional[TelemetryState] = None
    # The consensus audit's bookkeeping (replicated, like count) when the
    # transform was built with consensus=..., else None. The transform only
    # carries it; the audit runs in the train step
    # (make_train_step(consensus=...)), where the parameters and the
    # optimizer are in reach.
    audit: Optional[AuditState] = None
    # The cross-rank watch ring (per-rank data, like telem: the skew
    # columns differ by rank) when the transform was built with watch=...,
    # else None.
    watch: Optional[WatchState] = None
    # The adaptive controller's state (replicated, like count: its host
    # ints follow from replicated inputs, its window statistics from the
    # signal every rank reduces alike) when the transform was built with
    # adapt=..., else None.
    adapt: Optional["AdaptState"] = None
    # The size of the group init ran over (the JAX package's leading world
    # axis of the per-rank fields); None where unknown. Host bookkeeping: no
    # checkpoint stores it and no fingerprint folds it.
    world: Optional[int] = dataclasses.field(default=None, compare=False)


# The field split every layout-aware consumer agrees on, the JAX
# package's under the port's field names (its rng_key is the port's seed).
# VARYING fields hold per-rank data (a checkpoint writes them a file a
# rank); REPLICATED fields are the same on every rank (the consensus audit
# fingerprints them, an elastic resize carries them, but adapt, which it
# re-initializes).
GRACE_VARYING_FIELDS = ("mem", "comp", "telem", "watch")
GRACE_REPLICATED_FIELDS = ("count", "seed", "fallback", "audit", "adapt")
# Host bookkeeping of the port alone, outside both splits.
GRACE_HOST_FIELDS = ("world",)
# The observational varying fields: rings that record pipeline values as
# they are, so the guard's state scan strips them (they still roll back).
GRACE_OBSERVATIONAL_FIELDS = ("telem", "watch")


def _map_grace(fn, tree):
    """``tree`` with ``fn`` applied to every GraceState in it (through
    lists, tuples, dicts and the guard's state)."""
    from grace_tpu_torch.resilience.guard import GuardState
    if isinstance(tree, GraceState):
        return fn(tree)
    if isinstance(tree, GuardState):
        return tree.replace(inner=_map_grace(fn, tree.inner))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_grace(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_grace(fn, v) for k, v in tree.items()}
    return tree


def set_fallback_flag(tree, active: bool):
    """``tree`` with ``active`` written into the ``fallback`` flag of every
    GraceState in it; a tree without one comes back as it was."""
    return _map_grace(
        lambda g: dataclasses.replace(g, fallback=bool(active)), tree)


def fallback_flags(tree) -> list:
    """The ``fallback`` flags of every GraceState in ``tree``, in order."""
    flags: list = []

    def note(g):
        flags.append(g.fallback)
        return g

    _map_grace(note, tree)
    return flags


# -- state surgery: a resize carries, a new configuration migrates ------------

def _carry_value(value, conv):
    """A replicated field's value with ``conv`` applied to its tensors (an
    AdaptState's window statistics; host values as they are)."""
    from grace_tpu_torch.resilience.adapt import AdaptState
    if isinstance(value, torch.Tensor):
        return conv(value)
    if isinstance(value, AdaptState):
        return value.replace(err_sum=conv(value.err_sum),
                             err_peak=conv(value.err_peak))
    return value


def _graft(old, fresh, grace_fn, conv, who: str):
    """``old`` walked beside ``fresh``: every GraceState pair through
    ``grace_fn(old, fresh)``, a guard's counters from ``old`` around its
    grafted inner state, every other leaf from ``old`` (tensors through
    ``conv``; modules and optimizers as they are)."""
    from grace_tpu_torch.resilience.guard import _COUNTERS, GuardState

    def walk(o, f):
        if isinstance(o, GraceState):
            if not isinstance(f, GraceState):
                raise ValueError(
                    f"{who}: old tree has a GraceState where the fresh tree "
                    f"has {type(f).__name__} — the two states were built "
                    "from different optimizer chains.")
            return grace_fn(o, f)
        if isinstance(o, GuardState):
            if not isinstance(f, GuardState):
                raise ValueError(
                    f"{who}: old tree has a GuardState where the fresh tree "
                    f"has {type(f).__name__} — the two states were built "
                    "from different optimizer chains.")
            o.settle()
            return GuardState(inner=walk(o._inner, f._inner),
                              host_step=o.host_step,
                              **{n: conv(getattr(o, n)) for n in _COUNTERS})
        if isinstance(o, torch.Tensor):
            return conv(o)
        if isinstance(o, (torch.nn.Module, torch.optim.Optimizer)):
            return o
        if isinstance(o, tuple) and hasattr(o, "_fields"):
            return type(o)(*(walk(a, b) for a, b in zip(o, f)))
        if isinstance(o, (list, tuple)):
            return type(o)(walk(a, b) for a, b in zip(o, f))
        if isinstance(o, dict):
            return {k: walk(v, f[k]) for k, v in o.items()}
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return dataclasses.replace(o, **{
                fl.name: walk(getattr(o, fl.name), getattr(f, fl.name))
                for fl in dataclasses.fields(o)})
        return o

    return walk(old, fresh)


def carry_replicated(old_tree, fresh_tree, convert=None):
    """Graft the replicated payload of ``old_tree`` onto ``fresh_tree``,
    the transform's hook for an elastic world resize
    (:mod:`grace_tpu_torch.resilience.elastic`). ``fresh_tree`` is the
    same chain's state freshly initialized at the new world. Every
    GraceState keeps the fresh :data:`GRACE_VARYING_FIELDS` (residuals,
    compressor state and rings re-initialized, never re-partitioned) and
    the fresh ``world``, and takes the old
    :data:`GRACE_REPLICATED_FIELDS` bit for bit; every other leaf (a
    guard's counters, tensors, a module or optimizer) comes from
    ``old_tree``. ``convert`` (e.g. a move to another device) is applied
    to each carried tensor."""
    conv = convert if convert is not None else (lambda x: x)

    def grace(old, fresh):
        return dataclasses.replace(fresh, **{
            name: _carry_value(getattr(old, name), conv)
            for name in GRACE_REPLICATED_FIELDS})

    return _graft(old_tree, fresh_tree, grace, conv, "carry_replicated")


def _leaf_count(entry) -> int:
    return len(_state_tensors(entry))


def _structure(entry):
    """A mem/comp entry's tree structure: None, a leaf, or a dict's (or
    list's) structure of them (JAX's ``tree_structure``)."""
    if entry is None:
        return None
    if isinstance(entry, dict):
        return ("dict", tuple((k, _structure(v))
                              for k, v in sorted(entry.items())))
    if isinstance(entry, (list, tuple)):
        return ("seq", tuple(_structure(v) for v in entry))
    return "leaf"


def _migrate_leaf(old, fresh):
    """One leaf of the cross-config migration, ``(leaf, verdict)``:
    ``carried`` (same shape and dtype: the old leaf, bit for bit),
    ``overlap`` (same dtype and all dimensions but the last: the shared
    leading columns of the last axis carried over the fresh init, the
    PowerSGD rank-change rule) or ``fresh``."""
    if old.dtype != fresh.dtype:
        return fresh, "fresh"
    if old.shape == fresh.shape:
        return old, "carried"
    if old.dim() == fresh.dim() and old.dim() >= 1 \
            and old.shape[:-1] == fresh.shape[:-1]:
        k = min(old.shape[-1], fresh.shape[-1])
        out = fresh.clone()
        out[..., :k] = old[..., :k].to(out.device)
        return out, "overlap"
    return fresh, "fresh"


def migrate_state_tree(old, fresh):
    """Leafwise migration of one varying field (a GraceState's ``mem`` or
    ``comp`` list) from an old configuration's layout onto a fresh init
    under the new one (:func:`_migrate_leaf`). Structures that differ
    migrate nothing. Returns ``(entries, {"carried", "overlap", "fresh",
    "structure_match"})``, the JAX package's counts."""
    match = _structure(old) == _structure(fresh)
    stats = {"carried": 0, "overlap": 0, "fresh": 0,
             "structure_match": match}
    if not match:
        stats["fresh"] = _leaf_count(fresh)
        return fresh, stats

    def walk(o, f):
        if f is None:
            return None
        if isinstance(f, dict):
            return {k: walk(o[k], v) for k, v in f.items()}
        if isinstance(f, (list, tuple)):
            return type(f)(walk(a, b) for a, b in zip(o, f))
        out, verdict = _migrate_leaf(o, f)
        stats[verdict] += 1
        return out

    return walk(old, fresh), stats


def migrate_grace_state(old_tree, fresh_tree, convert=None):
    """Cross-configuration GraceState migration at one world (a retune's
    state surgery; :func:`carry_replicated` is the cross-world twin):

    * ``count``, ``seed``, ``fallback`` and ``audit`` carry bit for bit;
    * ``adapt`` takes the fresh init (the ladder changed: the old window
      statistics and rung mean nothing under it);
    * ``mem`` and ``comp`` migrate leafwise (:func:`migrate_state_tree`):
      residuals carry where their shapes agree, compressor state whole or
      by column overlap (a PowerSGD rank change warm-starts Q), else fresh;
    * ``telem`` and ``watch`` take the fresh rings;
    * every other leaf comes from ``old_tree``.

    Returns ``(state, stats)`` with the per-field counts."""
    conv = convert if convert is not None else (lambda x: x)
    stats = {"mem": {"carried": 0, "overlap": 0, "fresh": 0},
             "comp": {"carried": 0, "overlap": 0, "fresh": 0},
             "mem_structure_match": True, "comp_structure_match": True}

    def grace(old, fresh):
        out = {}
        for name in ("mem", "comp"):
            entries, st = migrate_state_tree(getattr(old, name),
                                             getattr(fresh, name))
            for k in ("carried", "overlap", "fresh"):
                stats[name][k] += st[k]
            stats[f"{name}_structure_match"] &= st["structure_match"]
            out[name] = [_migrated(e, conv) for e in entries]
        return dataclasses.replace(fresh, **out, **{
            name: _carry_value(getattr(old, name), conv)
            for name in GRACE_REPLICATED_FIELDS if name != "adapt"})

    return _graft(old_tree, fresh_tree, grace, conv,
                  "migrate_grace_state"), stats


def _migrated(entry, conv):
    if isinstance(entry, torch.Tensor):
        return conv(entry)
    if isinstance(entry, dict):
        return {k: _migrated(v, conv) for k, v in entry.items()}
    return entry


@dataclasses.dataclass(frozen=True)
class GraceTransform:
    compressor: Compressor
    memory: Memory
    communicator: Communicator
    seed: int = 0
    fusion: Fusion = None     # None, 'flat', 'grouped' or bucket bytes
    routes: Tuple = ()        # normalized ((pattern, comp, mem, comm), ...)
    escape: Optional[Compressor] = None         # the dense escape codec
    telemetry: Optional[TelemetryConfig] = None
    topology: Optional[Topology] = None         # prices the link split
    consensus: bool = False                     # carry an AuditState
    watch: Optional[WatchConfig] = None
    adapt: Optional["AdaptConfig"] = None      # the adaptive ladder
    mesh: Optional[MeshSpec] = None             # the dp×fsdp layout
    _wire_plans: dict = dataclasses.field(default_factory=dict,
                                          compare=False, repr=False)

    @property
    def _grouped(self) -> bool:
        return self.fusion == "grouped"

    @property
    def _bucketed(self) -> bool:
        return self.fusion is not None and not self._grouped

    def leaf_triads(self, names) -> list:
        """Each leaf's ``(compressor, memory, communicator)``: its route's,
        else the base triad."""
        base = (self.compressor, self.memory, self.communicator)
        return [route_for(self.routes, leaf_path_str(n), base)
                for n in names]

    def init(self, params: Mapping[str, torch.Tensor]) -> GraceState:
        names = leaf_order(params)
        leaves = [params[n] for n in names]
        if self.routes:
            triads = self.leaf_triads(names)
            mem = [m.init_state(p) for p, (_, m, _) in zip(leaves, triads)]
            comp = [c.init_state(p) for p, (c, _, _) in zip(leaves, triads)]
        elif self._grouped:
            groups = _group_views(leaves)
            mem = [_stack_states([self.memory.init_state(leaves[i])
                                  for i in idxs]) for idxs in groups]
            comp = [_stack_states([self.compressor.init_state(leaves[i])
                                   for i in idxs]) for idxs in groups]
        else:
            if self._bucketed:
                leaves = self._bucket_buffers(leaves)[1]
            mem = [self.memory.init_state(p) for p in leaves]
            comp = [self.compressor.init_state(p) for p in leaves]
        device = leaves[0].device if leaves else None
        adapt = None
        if self.adapt is not None:
            from grace_tpu_torch.resilience.adapt import adapt_init
            self._check_rungs(leaves)
            adapt = adapt_init(self.adapt, device)
        return GraceState(
            count=0, seed=self.seed, mem=mem, comp=comp,
            telem=(telemetry_init(self.telemetry, device)
                   if self.telemetry is not None else None),
            audit=audit_init() if self.consensus else None,
            watch=(watch_init(self.watch, device)
                   if self.watch is not None else None),
            adapt=adapt, world=self.communicator.world_size())

    def _check_rungs(self, leaves) -> None:
        """Every rung's compressor state must have the base codec's
        structure, shapes and dtypes on the structures the executor
        compresses (the JAX package's ``lax.switch`` returns one state
        type); raise its ``ValueError`` otherwise. ``leaves``: the
        structures ``init`` allocated state for."""
        def sig(entry):
            if entry is None:
                return None
            if isinstance(entry, dict):
                return tuple((k, sig(v)) for k, v in sorted(entry.items()))
            return (tuple(entry.shape), entry.dtype)

        for codec in self.adapt.ladder:
            if codec is self.compressor:
                continue
            for leaf in leaves:
                want = sig(self.compressor.init_state(leaf))
                got = sig(codec.init_state(leaf))
                if got != want:
                    raise ValueError(
                        "adapt ladder rungs must thread identical mem/comp "
                        "state structures (the JAX package's lax.switch "
                        "branches return one state type) — a rung whose "
                        "compressor state changes shape per rung cannot "
                        "ride one ladder. PowerSGD rank ladders need a "
                        "uniform padded state: set state_rank to the "
                        "ladder's max rank on every rung (grace_from_params "
                        f"does this automatically): {type(codec).__name__} "
                        f"keeps {got} where {type(self.compressor).__name__}"
                        f" keeps {want} for a leaf of shape "
                        f"{tuple(leaf.shape)}")

    def _bucket_buffers(self, leaves):
        """The bucket plan of these leaves and each bucket's flat buffer at
        the common dtype, its leaves concatenated in leaf order."""
        buckets, cdtype = _bucketize([_struct(l) for l in leaves],
                                     _bucket_bytes(self.fusion))
        flats = [torch.cat([leaves[i].reshape(-1).to(cdtype)
                            for i in idxs]) for idxs in buckets]
        return buckets, flats

    def update(self, grads: Mapping[str, torch.Tensor], state: GraceState
               ) -> Tuple[Dict[str, torch.Tensor], GraceState]:
        """Local gradients → globally aggregated updates, by the executor
        that ``fusion`` and ``routes`` select (module docstring), or by the
        dense escape while ``state.fallback`` is set."""
        names = leaf_order(grads)
        leaves = [grads[n] for n in names]
        if self.telemetry is not None and state.telem is None:
            raise ValueError(
                "grace_transform was built with telemetry=... but the state "
                "has no telemetry ring — it was initialized by a transform "
                "without telemetry (or restored from such a checkpoint). "
                "Re-init the optimizer state with the telemetry-enabled "
                "transform.")
        if self.watch is not None and state.watch is None:
            raise ValueError(
                "grace_transform was built with watch=... but the state has "
                "no watch ring — it was initialized by a transform without "
                "watch (or restored from such a checkpoint). Re-init the "
                "optimizer state with the watch-enabled transform.")
        rung, codec = None, self.compressor
        if self.adapt is not None:
            if state.adapt is None:
                raise ValueError(
                    "grace_transform was built with adapt=... but the state "
                    "has no AdaptState — it was initialized by a transform "
                    "without adapt (or restored from such a checkpoint). "
                    "Re-init the optimizer state with the adapt-enabled "
                    "transform.")
            # The effective rung: the dense escape while the guard's flag
            # is set, else the commanded rung (a boundary's decision is
            # made here, where the rung is first needed).
            rung = (0 if state.fallback else
                    min(max(state.adapt.settle().rung, 0),
                        self.adapt.top_rung))
            if rung:
                codec = self.adapt.ladder[rung - 1]
            dense = rung == 0
        else:
            dense = self.escape is not None and bool(state.fallback)
        plan = (self._bucket_buffers(leaves)
                if self._bucketed and not dense else None)
        if self.telemetry is not None:
            # Before the exchange: an all-reduce may sum into the
            # gradients in place (the identity codec's payload).
            with trace_stage(STAGE_TELEMETRY):
                grad_sq = _sqsum(leaves)
                err_sq = (self._codec_error_sq(names, leaves, plan, state,
                                               codec)
                          if self.telemetry.compression_error and not dense
                          else None)
        if dense:
            outs, mem, comp = self._run_dense(leaves, state)
        elif self._grouped:
            outs, mem, comp = self._update_grouped(leaves, state, codec)
        elif self._bucketed:
            outs, mem, comp = self._update_bucketed(leaves, state, plan,
                                                    codec)
        else:
            if len(state.mem) != len(names):
                raise ValueError(
                    f"grace state holds {len(state.mem)} buffers but this "
                    f"transform (fusion=None) runs {len(names)} pipelines "
                    "over these gradients: the state was built for another "
                    "parameter set or fusion setting. Re-init it.")
            outs, mem, comp = self._update_per_leaf(names, leaves, state,
                                                    codec)
        telem, watch, adapt = state.telem, state.watch, state.adapt
        if self.telemetry is not None:
            grad_norm = torch.sqrt(grad_sq)
            err = 0.0
            if err_sq is not None:
                err = torch.sqrt(err_sq) / torch.clamp(grad_norm, min=1e-20)
            if self.adapt is not None:
                from grace_tpu_torch.resilience.adapt import (adapt_advance,
                                                              adapt_signal)
                if err_sq is None:       # the dense rung: nothing lossy
                    err = torch.zeros((), dtype=torch.float32,
                                      device=grad_sq.device)
                with trace_stage(STAGE_ADAPT):
                    err_mean, err_peak = adapt_signal(
                        err, self.communicator.group)
                    adapt = adapt_advance(state.adapt, self.adapt,
                                          state.count, state.fallback,
                                          err_mean, err_peak)
            with trace_stage(STAGE_TELEMETRY):
                telem, watch = self._telemetry_next(
                    state, names, leaves, outs, mem, grad_norm, err, codec,
                    dense, rung)
        return dict(zip(names, outs)), dataclasses.replace(
            state, count=state.count + 1, mem=mem, comp=comp, telem=telem,
            watch=watch, adapt=adapt)

    def _run_dense(self, leaves, state: GraceState):
        """The escape: a dense ``escape``-coded all-reduce of the raw
        gradients, leaf by leaf under each leaf's key; mem and comp pass
        through untouched, so error feedback resumes where it paused."""
        from grace_tpu_torch.comm import Allreduce

        allreduce = Allreduce(group=self.communicator.group)
        outs = []
        with trace_stage(STAGE_DENSE_ESCAPE):
            for i, g in enumerate(leaves):
                payload, ctx, _ = self.escape.compress(
                    g, self.escape.init_state(g),
                    _step_key(state, i))
                outs.append(allreduce.exchange(payload, ctx, self.escape)
                            .to(g.dtype))
        return outs, state.mem, state.comp

    # -- telemetry -----------------------------------------------------------

    def _roundtrip_items(self, names, leaves, plan, state: GraceState,
                         codec: Optional[Compressor] = None):
        """``(x, comp_state, key, codec)`` of every compress call the active
        executor makes, with the keys it makes them under (``plan``: the
        bucket plan and buffers of a bucketed executor; ``codec``: the
        active rung's, for the base one)."""
        codec = codec or self.compressor
        if self._grouped:
            items = []
            for gi, idxs in enumerate(_group_views(leaves)):
                keys = _step_key(state, gi).split(len(idxs))
                comps = _unstack_state(state.comp[gi], len(idxs))
                items += [(leaves[i], cs, key, codec)
                          for i, cs, key in zip(idxs, comps, keys)]
            return items
        if self._bucketed:
            return [(f, state.comp[b], _step_key(state, b),
                     codec) for b, f in enumerate(plan[1])]
        codecs = ([c for c, _, _ in self.leaf_triads(names)] if self.routes
                  else [codec] * len(leaves))
        return [(g, state.comp[i], _step_key(state, i), c)
                for i, (g, c) in enumerate(zip(leaves, codecs))]

    def _codec_error_sq(self, names, leaves, plan, state: GraceState,
                        codec: Optional[Compressor] = None) -> torch.Tensor:
        """Σ‖x − decompress(compress(x))‖² over the structures (and keys)
        the active executor compresses, without error feedback, under
        ``codec`` (the active rung's; None: the base codec). A codec with a
        grouped round-trip (chunk Top-K's kernel) takes all of its
        structures in one launch; the rest go one by one."""
        items = self._roundtrip_items(names, leaves, plan, state, codec)
        diffs, by_codec = [], {}
        for j, item in enumerate(items):
            by_codec.setdefault(id(item[3]), []).append(j)
        for idxs in by_codec.values():
            codec = items[idxs[0]][3]
            fused = getattr(codec, "fused_roundtrip_leaves", None)
            done = set()
            if fused is not None:
                got = fused([items[j][0] for j in idxs])
                if got is not None:
                    taken, errs = got
                    diffs += errs
                    done = {idxs[t] for t in taken}
            for j in idxs:
                if j not in done:
                    x, cs, key, _ = items[j]
                    payload, ctx, _ = codec.compress(x, cs, key)
                    diffs.append(x - codec.decompress(payload, ctx))
        return _sqsum(diffs)

    def _wire_plan(self, names, leaves, world: int,
                   codec: Optional[Compressor] = None):
        """``(dense, link, escape_link, negotiation)`` bytes of one step of
        these leaves under the active executor at ``world`` ranks, as the
        JAX package prices them: the raw dense bytes, the received bytes
        by link class (:meth:`Communicator.recv_link_bytes` under the
        transform's topology; byte buckets priced a bucket at a time), the
        escape's all-reduce, and the negotiation collectives. ``codec``
        prices an adaptive rung's codec in place of the base one.
        Integers, cached per leaf signature, world and codec."""
        from grace_tpu_torch.comm import Allreduce
        from grace_tpu_torch.utils.metrics import payload_nbytes

        codec = codec or self.compressor
        structs = [_struct(l) for l in leaves]
        key = (tuple(names) if self.routes else None, tuple(structs), world,
               id(codec))
        plan = self._wire_plans.get(key)
        if plan is not None:
            return plan
        topo = self.topology
        n_elems = sum(math.prod(s) for s, _ in structs)
        dense = sum(math.prod(s) * d.itemsize for s, d in structs)
        if self.routes:
            ici = dcn = wan = neg_b = 0
            for s, (comp, _m, cm) in zip(structs, self.leaf_triads(names)):
                ne = math.prod(s[0])
                lb = cm.recv_link_bytes(
                    payload_nbytes(comp, s), ne, world, topology=topo,
                    vote=bool(getattr(comp, "vote_aggregate", False)))
                ici, dcn, wan = ici + lb.ici, dcn + lb.dcn, wan + lb.wan
                neg_b += negotiation_bytes_for(comp, ne, world)
            link = LinkBytes(ici=ici, dcn=dcn, wan=wan)
        else:
            vote = bool(getattr(codec, "vote_aggregate", False))
            payloads = fusion_payload_structs(structs, self.fusion)
            if self._bucketed and self.fusion != "flat":
                # One collective chain a bucket: the sum of bucket prices
                # (ring schedules round a collective at a time).
                ici = dcn = wan = 0
                for s, count in payloads:
                    lb = self.communicator.recv_link_bytes(
                        payload_nbytes(codec, s), math.prod(s[0]),
                        world, topology=topo, vote=vote)
                    ici += count * lb.ici
                    dcn += count * lb.dcn
                    wan += count * lb.wan
                link = LinkBytes(ici=ici, dcn=dcn, wan=wan)
            else:
                comp_b = sum(payload_nbytes(codec, s) * count
                             for s, count in payloads)
                link = self.communicator.recv_link_bytes(
                    comp_b, n_elems, world, topology=topo, vote=vote)
            neg_b = sum(count * negotiation_bytes_for(
                codec, math.prod(s[0]), world)
                for s, count in payloads)
        esc_link = None
        if self.escape is not None:
            esc_b = sum(payload_nbytes(self.escape, s) for s in structs)
            esc_link = Allreduce(group=self.communicator.group) \
                .recv_link_bytes(esc_b, n_elems, world, topology=topo)
        plan = self._wire_plans[key] = (dense, link, esc_link, neg_b)
        return plan

    def _telemetry_next(self, state: GraceState, names, leaves, outs,
                        new_mem, grad_norm, err, codec: Compressor,
                        dense: bool, rung: Optional[int]):
        """The ring with this update's row and the watch ring with the
        window's summary (when it is due): every value computed on the
        device or known on the host, nothing read back. ``err`` is the
        relative compression error of what ran; the row prices the
        escape's all-reduce when ``dense``, else ``codec``'s plan (the
        active rung's), plus the adaptive signal's cost when the ladder is
        armed; ``rung`` is the effective rung (None: not armed)."""
        world = self.communicator.world_size()
        dense_b, link, esc_link, neg_b = self._wire_plan(names, leaves,
                                                         world, codec)
        fallback = bool(state.fallback)
        mem_leaves = [t for t in _state_tensors(new_mem)
                      if t.is_floating_point()]
        if mem_leaves:
            residual_norm = torch.sqrt(_sqsum(mem_leaves))
            residual_max = _absmax(mem_leaves)
        else:
            residual_norm = residual_max = 0.0
        eff, ngb = (esc_link, 0) if dense else (link, neg_b)
        ab = 0.0
        if self.adapt is not None:
            from grace_tpu_torch.resilience.adapt import adapt_signal_bytes
            ab = float(adapt_signal_bytes(world))
        tiers = {"ici": float(eff.ici), "dcn": float(eff.dcn),
                 "wan": float(eff.wan)}
        # The negotiation and the adaptive signal are flat full-group
        # collectives: their bytes ride the worst tier the group spans.
        tiers[(self.topology or Topology()).flat_tier(world)] += (
            float(ngb) + ab)
        wire = float(eff.total) + float(ngb) + ab
        watch, wb = state.watch, 0.0
        if self.watch is not None and state.count % self.watch.window == 0:
            # The window predicate is the host's step counter, the same on
            # every rank, so every rank joins the gather at the same steps.
            with trace_stage(STAGE_WATCH):
                watch = watch_record(
                    state.watch, state.count,
                    {"grad_norm": grad_norm, "compression_error": err,
                     "residual_norm": residual_norm},
                    self.communicator.group)
            # A flat full-group collective, priced like the negotiation:
            # into wire_bytes and the tier the group spans.
            wb = float(watch_gather_bytes(world))
            tiers[(self.topology or Topology()).flat_tier(world)] += wb
            wire += wb
        telem = telemetry_record(state.telem, state.count, {
            "grad_norm": grad_norm,
            "update_norm": torch.sqrt(_sqsum(outs)),
            "residual_norm": residual_norm,
            "residual_max": residual_max,
            "compression_error": err,
            "wire_bytes": wire,
            "dense_bytes": float(dense_b),
            "fallback": float(fallback),
            "audit_bytes": 0.0,
            "wire_bytes_ici": tiers["ici"],
            "wire_bytes_dcn": tiers["dcn"],
            "wire_bytes_wan": tiers["wan"],
            "watch_bytes": wb,
            "negotiation_bytes": float(ngb),
            "adapt_rung": -1.0 if rung is None else float(rung),
            "adapt_bytes": ab,
        })
        return telem, watch

    def _update_per_leaf(self, names, leaves, state: GraceState,
                         codec: Compressor):
        """One pipeline a leaf under ``codec``. Routed leaves are
        partitioned by triad, in order of each triad's first leaf, and each
        part runs through its communicator's ``step_leaves``; every leaf
        keeps its own key."""
        keys = [_step_key(state, i)
                for i in range(len(names))]
        triads = (self.leaf_triads(names) if self.routes
                  else [(codec, self.memory, self.communicator)]
                  * len(names))
        parts: dict = {}
        for i, triad in enumerate(triads):
            parts.setdefault(tuple(map(id, triad)), (triad, []))[1].append(i)
        outs = [None] * len(names)
        mem, comp = list(state.mem), list(state.comp)
        for (c, m, cm), idxs in parts.values():
            o, ms, cs = cm.step_leaves(
                [leaves[i] for i in idxs], [state.mem[i] for i in idxs],
                [state.comp[i] for i in idxs], m, c, [keys[i] for i in idxs])
            for i, oi, mi, ci in zip(idxs, o, ms, cs):
                outs[i], mem[i], comp[i] = oi, mi, ci
        return outs, mem, comp

    def _update_grouped(self, leaves, state: GraceState, codec: Compressor):
        groups = _group_views(leaves)
        if len(state.mem) != len(groups):
            raise ValueError(
                f"grace state has {len(state.mem)} groups but the leaves "
                f"form {len(groups)} — {_REINIT}")
        outs = [None] * len(leaves)
        mem, comp = [], []
        for gi, idxs in enumerate(groups):
            # The group count can coincide between fusion settings (a
            # per-leaf state whose leaves all differ in shape); the stacked
            # leading dimension cannot.
            for t in _state_tensors((state.mem[gi], state.comp[gi])):
                if t.dim() < 1 or t.shape[0] != len(idxs):
                    raise ValueError(
                        f"grace state group {gi} has a leaf of shape "
                        f"{tuple(t.shape)} but the group stacks {len(idxs)} "
                        f"same-shaped leaves (expected leading dim "
                        f"{len(idxs)}) — {_REINIT}")
            g = len(idxs)
            o, ms, cs = self.communicator.step_rows(
                [leaves[i] for i in idxs], _unstack_state(state.mem[gi], g),
                _unstack_state(state.comp[gi], g), self.memory, codec,
                _step_key(state, gi).split(g))
            for i, oi in zip(idxs, o):
                outs[i] = oi
            mem.append(_stack_states(ms))
            comp.append(_stack_states(cs))
        return outs, mem, comp

    def _update_bucketed(self, leaves, state: GraceState, plan,
                         codec: Compressor):
        """K independent pipelines under ``codec``, one a bucket: its
        leaves concatenated at the common dtype (``plan``:
        :meth:`_bucket_buffers` of them), one ``step`` under
        ``LeafKey(seed, count, b)`` with the bucket's own states, the result
        split back into the leaves and each cast to its dtype. Each bucket
        is its own ``step_leaves`` call under ``grace/bucket/<b>``, as in
        the JAX package: a communicator that groups leaves (the grouped
        Top-K, the grouped vote) would otherwise join the buckets into one
        compress, and no bucket's exchange could start before the last
        bucket's gradient."""
        buckets, flats = plan
        if len(state.mem) != len(buckets):
            raise ValueError(
                f"grace state has {len(state.mem)} buffers but the fusion "
                f"plan has {len(buckets)} buckets — {_REINIT}")
        out_flats, mem, comp = [], [], []
        with trace_stage(STAGE_BUCKET):
            for b, flat in enumerate(flats):
                with trace_stage(f"{STAGE_BUCKET}/{b}"):
                    o, m, c = self.communicator.step_leaves(
                        [flat], [state.mem[b]], [state.comp[b]],
                        self.memory, codec, [_step_key(state, b)])
                out_flats += list(o)
                mem += list(m)
                comp += list(c)
        outs = [None] * len(leaves)
        for idxs, out in zip(buckets, out_flats):
            off = 0
            for i in idxs:
                size = leaves[i].numel()
                outs[i] = out[off:off + size].reshape(leaves[i].shape).to(
                    leaves[i].dtype)
                off += size
        return outs, list(mem), list(comp)


def check_fusion(fusion: Fusion, routed: bool = False) -> None:
    """Raise ``ValueError`` unless ``fusion`` is None, ``'flat'``,
    ``'grouped'`` or an integer count of bytes, and None where the leaves
    are ``routed``."""
    if not (fusion is None or fusion in ("flat", "grouped") or (
            isinstance(fusion, int) and not isinstance(fusion, bool))):
        raise ValueError(f"fusion must be None, 'flat', 'grouped', or int "
                         f"bytes; got {fusion!r}")
    if routed and fusion is not None:
        raise ValueError(
            "routes=... requires fusion=None: per-leaf codec routing is "
            "per-leaf semantics — 'flat'/'grouped'/bucketed fusion "
            "concatenates or stacks leaves, which would fuse leaves "
            "with different codecs into one payload. Route instead of "
            "fusing (each leaf family already gets its own collective). "
            f"Got fusion={fusion!r}.")


def _normalize_telemetry(telemetry) -> Optional[TelemetryConfig]:
    """The telemetry knob's spellings: None/False (off), True (defaults),
    an int (ring capacity), a dict (config kwargs) or a TelemetryConfig."""
    if telemetry is None or telemetry is False:
        return None
    if telemetry is True:
        return TelemetryConfig()
    if isinstance(telemetry, TelemetryConfig):
        return telemetry
    if isinstance(telemetry, int):
        return TelemetryConfig(capacity=telemetry)
    if isinstance(telemetry, dict):
        return TelemetryConfig(**telemetry)
    raise TypeError(f"telemetry must be None/bool/int/dict/TelemetryConfig; "
                    f"got {type(telemetry).__name__}")


def grace_transform(compressor: Compressor, memory: Memory,
                    communicator: Communicator, seed: int = 0,
                    fusion: Fusion = None,
                    routes: Optional[Sequence] = None,
                    escape: Optional[Compressor] = None, telemetry=None,
                    topology: Optional[Topology] = None, consensus=None,
                    watch=None, adapt=None, mesh=None) -> GraceTransform:
    """Build the compressed-exchange transform (module docstring): the
    executor is picked by ``fusion`` (None, ``'flat'``, ``'grouped'`` or
    bucket bytes) and ``routes`` (``[(pattern, triad), ...]``, see
    :func:`normalize_routes`; they need ``fusion=None``).

    ``escape`` is the dense codec of the fallback window (``NoneCompressor``
    or ``FP16Compressor``); ``telemetry`` arms the ring (None, True, a
    capacity, a dict or a :class:`TelemetryConfig`); ``topology`` is the
    link layout the ring prices its per-link split under (None: detected
    once, here, when telemetry is on: ``Topology.detect``, a collective
    of the communicator's process group, so a group of survivors builds
    its transform without the ranks that left).

    ``consensus`` (None, True, ``audit_every``, a dict or a
    :class:`~grace_tpu_torch.resilience.consensus.ConsensusConfig`) makes
    the state carry an :class:`AuditState`; the audit itself is the train
    step's ``consensus=`` hook. ``watch`` (None, True, a window, a dict or
    a :class:`~grace_tpu_torch.telemetry.aggregate.WatchConfig`) arms the
    cross-rank watch ring: every ``window``-th update gathers each rank's
    gradient norm, compression error and residual norm and writes the
    summary row; it needs ``telemetry``, whose row prices the gather.

    ``adapt`` (None, True, a window, a dict with built ladder codecs or an
    :class:`~grace_tpu_torch.resilience.adapt.AdaptConfig`) arms the
    adaptive ladder (module docstring); it needs ``escape`` (rung 0),
    ``telemetry`` with its compression error (the signal) and no
    ``routes`` (a rung swaps the codec wholesale).

    ``mesh`` (None, an axis-name str or a :class:`MeshSpec`): the layout the
    transform runs under. None or a str is pure data parallelism over the
    communicator's group. A 2-D spec declares the sharded-model track: the
    exchange is the per-shard reduce over the dp axis, so a spec that
    :func:`~grace_tpu_torch.parallel.make_mesh` bound must have its
    ``dp_group`` as the communicator's group (``grace_from_params(params,
    group=mesh)`` builds it so)."""
    mesh = MeshSpec.normalize(mesh)
    if mesh.bound and communicator.group is not mesh.dp_group:
        raise ValueError(
            f"mesh.dp_axis {mesh.dp_axis!r} (its dp group "
            f"{mesh.dp_group!r}) differs from the communicator's group "
            f"{communicator.group!r} — the compressed exchange IS the "
            "per-shard reduce over the dp axis, so the two must name the "
            "same mesh axis.")
    routes = normalize_routes(routes, communicator) if routes else ()
    check_fusion(fusion, bool(routes))
    if fusion == "grouped" and communicator.shard_parallel:
        raise ValueError(
            "fusion='grouped' runs the per-leaf pipeline over stacks of "
            "same-shaped leaves and is validated for the exchange-based "
            "communicator families (Allreduce/Allgather/Broadcast/"
            "SignAllreduce/Identity); "
            f"{type(communicator).__name__} re-chunks the gradient into "
            "per-rank shards inside step() (shard-parallel family: "
            "TwoShotAllreduce/RingAllreduce/ReduceScatterAllreduce/"
            "HierarchicalAllreduce) — use fusion=None, 'flat', or integer "
            "byte buckets, which hand the communicator whole buffers to "
            "shard.")
    if escape is not None and not (getattr(escape, "summable_payload", False)
                                   and escape.average):
        raise ValueError(
            "escape must be a dense, summable, averaging compressor "
            "(NoneCompressor/FP16Compressor) — the escape hatch psums its "
            f"payload; got {type(escape).__name__}.")
    telemetry = _normalize_telemetry(telemetry)
    watch = normalize_watch(watch)
    if watch is not None and telemetry is None:
        raise ValueError(
            "watch=... requires telemetry=...: graft-watch summarizes the "
            "telemetry row's health scalars cross-rank and folds its "
            "gather cost into the ring's wire_bytes — arm "
            "grace_transform(telemetry=True) (or a capacity/config) "
            "alongside watch.")
    if adapt is not None and adapt is not False:
        # Lazy: resilience imports this module.
        from grace_tpu_torch.resilience.adapt import normalize_adapt
        adapt = normalize_adapt(adapt, compressor)
        if escape is None:
            raise ValueError(
                "adapt=... requires escape=...: the degradation ladder's "
                "rung 0 IS the dense escape path (the same codec+psum the "
                "guard's fallback window routes through) — arm "
                "grace_transform(escape=FP16Compressor()/NoneCompressor()) "
                "alongside adapt.")
        if telemetry is None or not telemetry.compression_error:
            raise ValueError(
                "adapt=... requires telemetry=... with "
                "compression_error=True: the controller's windowed signal "
                "IS the telemetry row's relative compression error "
                "(computed against the active rung's codec) — arm "
                "grace_transform(telemetry=True) alongside adapt.")
        if routes:
            raise ValueError(
                "adapt=... requires routes=None: the ladder swaps the "
                "base codec wholesale each rung; per-leaf route "
                "sub-triads are outside the rung plan (route OR adapt, "
                "not both).")
    else:
        adapt = None
    armed = consensus is not None and consensus is not False
    if armed:
        # Lazy: resilience imports this module.
        from grace_tpu_torch.resilience.consensus import normalize_consensus
        normalize_consensus(consensus)            # JAX's errors, at build
    if topology is None and telemetry is not None:
        topology = Topology.detect(group=communicator.group)
    return GraceTransform(compressor, memory, communicator, seed=seed,
                          fusion=fusion, routes=routes, escape=escape,
                          telemetry=telemetry, topology=topology,
                          consensus=armed, watch=watch, adapt=adapt,
                          mesh=mesh)
