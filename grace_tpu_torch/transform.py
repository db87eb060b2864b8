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
"""

from __future__ import annotations

import dataclasses
import fnmatch
import functools
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from grace_tpu_torch.core import (Communicator, Compressor, LeafKey, Memory,
                                  State)

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
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, (dict, tuple)):
        values = state.values() if isinstance(state, dict) else state
        return [t for v in values for t in _state_tensors(v)]
    return []


_REINIT = ("the state was built under a different fusion setting. Re-init "
           "the optimizer state (or restore a checkpoint written with the "
           "same fusion config).")


@dataclasses.dataclass
class GraceState:
    count: int                # step counter, the same on every rank
    seed: int                 # base of the per-(step, leaf) streams
    mem: List[State]          # memory state per leaf, group or bucket
    comp: List[State]         # compressor state likewise


@dataclasses.dataclass(frozen=True)
class GraceTransform:
    compressor: Compressor
    memory: Memory
    communicator: Communicator
    seed: int = 0
    fusion: Fusion = None     # None, 'flat', 'grouped' or bucket bytes
    routes: Tuple = ()        # normalized ((pattern, comp, mem, comm), ...)

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
        return GraceState(count=0, seed=self.seed, mem=mem, comp=comp)

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
        that ``fusion`` and ``routes`` select (module docstring)."""
        names = leaf_order(grads)
        leaves = [grads[n] for n in names]
        if self._grouped:
            outs, mem, comp = self._update_grouped(leaves, state)
        elif self._bucketed:
            outs, mem, comp = self._update_bucketed(leaves, state)
        else:
            if len(state.mem) != len(names):
                raise ValueError(
                    f"grace state holds {len(state.mem)} buffers but this "
                    f"transform (fusion=None) runs {len(names)} pipelines "
                    "over these gradients: the state was built for another "
                    "parameter set or fusion setting. Re-init it.")
            outs, mem, comp = self._update_per_leaf(names, leaves, state)
        return dict(zip(names, outs)), GraceState(
            count=state.count + 1, seed=state.seed, mem=mem, comp=comp)

    def _update_per_leaf(self, names, leaves, state: GraceState):
        """One pipeline a leaf. Routed leaves are partitioned by triad, in
        order of each triad's first leaf, and each part runs through its
        communicator's ``step_leaves``; every leaf keeps its own key."""
        keys = [LeafKey(state.seed, state.count, i)
                for i in range(len(names))]
        triads = (self.leaf_triads(names) if self.routes
                  else [(self.compressor, self.memory, self.communicator)]
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

    def _update_grouped(self, leaves, state: GraceState):
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
                _unstack_state(state.comp[gi], g), self.memory,
                self.compressor,
                LeafKey(state.seed, state.count, gi).split(g))
            for i, oi in zip(idxs, o):
                outs[i] = oi
            mem.append(_stack_states(ms))
            comp.append(_stack_states(cs))
        return outs, mem, comp

    def _update_bucketed(self, leaves, state: GraceState):
        """K independent pipelines, one a bucket: its leaves concatenated
        at the common dtype, one ``step`` under ``LeafKey(seed, count, b)``
        with the bucket's own states, the result split back into the leaves
        and each cast to its dtype."""
        buckets, flats = self._bucket_buffers(leaves)
        if len(state.mem) != len(buckets):
            raise ValueError(
                f"grace state has {len(state.mem)} buffers but the fusion "
                f"plan has {len(buckets)} buckets — {_REINIT}")
        out_flats, mem, comp = self.communicator.step_leaves(
            flats, state.mem, state.comp, self.memory, self.compressor,
            [LeafKey(state.seed, state.count, b)
             for b in range(len(buckets))])
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


def grace_transform(compressor: Compressor, memory: Memory,
                    communicator: Communicator, seed: int = 0,
                    fusion: Fusion = None,
                    routes: Optional[Sequence] = None) -> GraceTransform:
    """Build the compressed-exchange transform (module docstring): the
    executor is picked by ``fusion`` (None, ``'flat'``, ``'grouped'`` or
    bucket bytes) and ``routes`` (``[(pattern, triad), ...]``, see
    :func:`normalize_routes`; they need ``fusion=None``)."""
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
    return GraceTransform(compressor, memory, communicator, seed=seed,
                          fusion=fusion, routes=routes)
