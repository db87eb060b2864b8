"""Device-free tracing of the port's steps: any config to a dispatch trace
on a CPU, at any world size; counterpart of the JAX package's
``analysis/trace.py``.

There is no jaxpr. A trace here is the op-by-op record of one rank's real
Python step, run on tensors without data:

* the tracer owns a default process group of PyTorch's ``"fake"`` backend
  at world ``W`` (:func:`fake_world`): every collective returns at once
  and is seen as the ``c10d`` dispatcher op it issues (``allreduce_``,
  ``_allgather_base_``, ``send``/``recv_``, ``alltoall_base_``,
  ``broadcast_``), with its group's member ranks;
* the step's tensors are ``FakeTensor``\\ s (shapes, dtypes, devices, no
  data), on ``"cuda"`` or ``"cpu"``: fake CUDA tensors exist on a machine
  without a card, so the card's route traces here too. Its kernel
  wrappers take their fake branch (:mod:`grace_tpu_torch.ops.fake`) and
  appear as one ``kernel`` node each; on ``"cpu"`` they run their plain
  versions, whose aten ops appear instead;
* a ``TorchDispatchMode`` records every aten and c10d op: the values it
  reads and writes, their shapes and dtypes, and the ``grace/...`` stage
  it ran under (:func:`grace_tpu_torch.telemetry.scopes.trace_stage`
  pushes onto the recorder's stack);
* a read of a device value on the host (``.item()``, ``.tolist()``,
  ``.numpy()``, ``bool(t)``, ``int(t)``, ``float(t)``: the port's form of
  the value a JAX ``lax.cond`` predicate computes) becomes a
  ``host_read`` node. The value the trace goes on with is a stub that the
  trace's :class:`Branch` chooses (zeros unless told otherwise).

Values are keyed on their storage and each write to it, never on Python
tensor identity: every c10d op writes into its output, and the port writes
in place (``add_``, ``copy_``, views), so an edge keyed on tensor objects
would drop the dependence an in-place write or a view carries.

Rank variance is seeded from the state's own structure (the port has no
``partition_specs``): gradients and the batch vary by rank, and so do
GraceState's per-rank fields (``transform.GRACE_VARYING_FIELDS``: ``mem``,
``comp``, ``telem``, ``watch``); counters, flags, parameters and the
ladder's statistics are replicated. On a dp×fsdp mesh the seeds are per
axis: the batch varies over dp only (both fsdp shards of a dp row read the
same rows), the GraceState fields over both.

The host branches of a config (the escape window, the ladder's rung, an
audit step) are host state in the port, so each is its own trace: a
:class:`Branch` sets them before the step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import sys
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Set, Tuple)
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from grace_tpu_torch.ops import fake as _fake_ops
from grace_tpu_torch.telemetry import scopes
from grace_tpu_torch.telemetry.scopes import match_stage

__all__ = ["Branch", "HostRead", "Node", "TensorRef", "TracedGraph",
           "fake_world", "default_param_structs", "trace_fn",
           "trace_update", "trace_train_step", "state_leaves",
           "DEFAULT_AXIS"]

DEFAULT_AXIS = "data"

# The default parameter tree of config audits, the JAX package's: flat size
# 512 = 8 * 64 shards evenly over the 8-way audit world, so bit-packing
# codecs cost the same packed per shard or whole.
_DEFAULT_PARAMS = (("w", (60, 8)), ("b", (32,)))


def default_param_structs() -> Dict[str, Tuple[Tuple[int, ...],
                                               torch.dtype]]:
    """``{name: (shape, float32)}`` of the default audit parameters."""
    return {name: (shape, torch.float32) for name, shape in _DEFAULT_PARAMS}


# -- the record ----------------------------------------------------------------

@dataclasses.dataclass
class Node:
    """One recorded op. ``kind``: ``"op"`` (aten), ``"collective"``
    (c10d), ``"kernel"`` (a kernel wrapper's fake launch), ``"host_read"``
    or ``"draw"`` (a ``LeafKey`` consumption: host-side, no values).
    ``ins``/``outs``: the value ids it reads and writes;
    ``in_meta``/``out_meta``: their ``(shape, dtype)``. ``attrs`` holds
    what a pass needs of the op: a collective's ``ranks`` (its group's
    global ranks), ``reduce_op``, ``peer`` (a p2p op's global peer) and
    ``nbytes`` (its operand bytes); a dtype view's ``src``/``dst``; a
    reduction's ``extent``; a host read's ``method``, ``site`` and
    ``index`` (its place among the trace's host reads); a ``_foreach_``
    op's ``edges`` (per output, the ids of the list elements it reads:
    one edge a list element, where ``ins`` joins them all); a draw's
    ``method``, ``shape``, ``dtype``, ``lineage``, ``fields`` and
    ``derived`` (the key's derived seed)."""

    idx: int
    kind: str
    name: str
    stage: str
    scope: str
    ins: Tuple[int, ...]
    outs: Tuple[int, ...]
    in_meta: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...] = ()
    out_meta: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...] = ()
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def out_nbytes(self) -> int:
        return sum(_nbytes(s, d) for s, d in self.out_meta)

    @property
    def in_nbytes(self) -> int:
        return sum(_nbytes(s, d) for s, d in self.in_meta)

    def sources(self, j: int) -> Tuple[int, ...]:
        """The values output ``j`` is computed from: its own list
        elements for a ``_foreach_`` op, else every input."""
        edges = self.attrs.get("edges")
        return edges[j] if edges is not None else self.ins


@dataclasses.dataclass(frozen=True)
class HostRead:
    """What a host read asks for: the stub chooser's argument."""

    method: str              # item, tolist, numpy, __bool__, ...
    site: str                # "<module path>:<function>" of the caller
    stage: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    index: int = -1          # its place among the trace's host reads


@dataclasses.dataclass(frozen=True)
class Branch:
    """One host branch of a step. ``fallback``: the escape window is open
    (``GraceState.fallback``); ``rung``: the adaptive ladder's commanded
    rung (None: the config's start); ``audit``: the step is an audit step
    of the consensus clock (train traces); ``count``: the GraceState's
    step counter before the step (the watch window's and the ladder
    window's clock); ``warmup``: steps run unrecorded before the traced
    one (a pending ladder boundary or guard verdict is then read in it);
    ``reads``: chooses the stub a host read returns (a callable of
    :class:`HostRead` giving an array-like, or None for zeros). It must
    not depend on the traced rank: the state passes trace a branch as
    rank 0 and as rank W−1 and compare the two."""

    label: str = "base"
    fallback: bool = False
    rung: Optional[int] = None
    audit: bool = False
    count: Optional[int] = None
    warmup: int = 0
    reads: Optional[Callable[[HostRead], Any]] = None


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


class TensorRef(NamedTuple):
    """A state tensor's identity in a trace: its storage and the value id
    of that storage's current write. Equal refs before and after a step:
    the leaf passed through untouched; the same storage with another
    ``vid``: written in place; another storage: replaced."""

    storage: int
    vid: int


def _storage_key(t: torch.Tensor) -> int:
    # The StorageImpl's address: the recorder keeps every storage it saw
    # alive, so no address is reused within a trace.
    return t.untyped_storage()._cdata


def _meta(t: torch.Tensor):
    return tuple(t.shape), t.dtype


# The c10d ops' writes and reads by argument name (their schemas carry no
# alias annotations).
_C10D_WRITES = {
    "allreduce_": ("tensors",), "allreduce_coalesced_": ("tensors",),
    "broadcast_": ("tensors",), "recv_": ("tensors",),
    "recv_any_source_": ("tensors",),
    "_allgather_base_": ("output_tensor",),
    "allgather_": ("output_tensors",),
    "allgather_into_tensor_coalesced_": ("outputs",),
    "alltoall_base_": ("output",), "alltoall_": ("output_tensors",),
    "_reduce_scatter_base_": ("output_tensor",),
    "reduce_scatter_": ("output_tensors",),
    "reduce_scatter_tensor_coalesced_": ("outputs",),
}
_P2P = ("send", "recv_", "recv_any_source_")
_HOST_READ_METHODS = frozenset({
    "item", "tolist", "numpy", "__bool__", "__int__", "__float__",
    "__index__", "__array__"})
# Ops whose output shape depends on the data: on the card each waits for
# the device to read a count back.
_SYNCING_OPS = frozenset({
    "aten.nonzero.default", "aten.masked_select.default",
    "aten.unique.default", "aten._unique2.default",
    "aten.unique_consecutive.default", "aten.unique_dim.default",
    "aten.repeat_interleave.Tensor", "aten.nonzero_static.default"})


_SCHEMAS: Dict[Any, Tuple[Tuple[str, bool], ...]] = {}


def _schema_args(func) -> Tuple[Tuple[str, bool], ...]:
    """``(name, written)`` of each argument of an aten op."""
    hit = _SCHEMAS.get(func)
    if hit is None:
        hit = _SCHEMAS[func] = tuple(
            (a.name, a.alias_info is not None and a.alias_info.is_write)
            for a in func._schema.arguments)
    return hit


def _flat_tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat_tensors(v)]
    return []


def _package_site() -> str:
    """``"<path>:<function>"`` of the innermost caller outside torch and
    this module: the code that asked for the host read."""
    here = os.path.dirname(os.path.abspath(__file__))
    torch_dir = os.path.dirname(torch.__file__)
    pkg = os.path.dirname(here)
    f = sys._getframe(1)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if not fn.startswith(torch_dir) and not fn.startswith(here) \
                and "ops" + os.sep + "fake.py" not in fn \
                and os.path.basename(fn) not in ("contextlib.py",):
            rel = (os.path.relpath(fn, pkg) if fn.startswith(pkg)
                   else os.path.basename(fn))
            return f"{rel.replace(os.sep, '/')}:{f.f_code.co_name}"
        f = f.f_back
    return "?"


class _Recorder:
    """The record of one trace (module docstring)."""

    def __init__(self, branch: Branch):
        self.branch = branch
        self.nodes: List[Node] = []
        self.values: Dict[int, Tuple[Tuple[int, ...], torch.dtype]] = {}
        self.current: Dict[int, int] = {}      # storage key -> value id
        self.roots: Dict[int, str] = {}        # value id -> label
        self.keep: List[Any] = []              # storages kept alive
        self.stack: List[str] = []
        self._quiet = 0
        self._p2p_sends: List[int] = []
        self.undo: List[Tuple[int, Optional[int]]] = []
        self._stages: Dict[str, str] = {}
        self.n_reads = 0                       # host reads so far
        self.scans: Set[int] = set()           # non-finite scan results
        # The stub chooser of quiet host reads (the state probes'), else
        # zeros.
        self.forced: Optional[Callable[[HostRead], Any]] = None

    @contextlib.contextmanager
    def quiet(self):
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    # -- values -----------------------------------------------------------
    def _new_value(self, t: torch.Tensor) -> int:
        vid = len(self.values)
        self.values[vid] = _meta(t)
        return vid

    def read(self, t: torch.Tensor) -> int:
        key = _storage_key(t)
        vid = self.current.get(key)
        if vid is None:                  # a constant made outside the trace
            vid = self._new_value(t)
            self.undo.append((key, None))
            self.current[key] = vid
            self.keep.append(t.untyped_storage())
        return vid

    def write(self, t: torch.Tensor) -> Tuple[int, Optional[int]]:
        """A new value of ``t``'s storage; also the value it overwrote
        when ``t`` covers only part of the storage (the rest survives)."""
        key = _storage_key(t)
        old = self.current.get(key)
        storage = t.untyped_storage()
        partial = (old is not None
                   and t.numel() * t.element_size() < storage.nbytes())
        vid = self._new_value(t)
        self.undo.append((key, old))
        self.current[key] = vid
        self.keep.append(storage)
        return vid, (old if partial else None)

    def mark(self) -> Tuple[int, int]:
        return len(self.nodes), len(self.undo)

    def rollback(self, mark: Tuple[int, int]) -> None:
        """Forget what was recorded since ``mark`` (a call that failed
        and runs again)."""
        n_nodes, n_undo = mark
        del self.nodes[n_nodes:]
        while len(self.undo) > n_undo:
            key, old = self.undo.pop()
            if old is None:
                self.current.pop(key, None)
            else:
                self.current[key] = old

    def root(self, t: torch.Tensor, label: str) -> int:
        vid, _ = self.write(t)
        self.roots[vid] = label
        return vid

    # -- nodes ------------------------------------------------------------
    def _stage(self) -> Tuple[str, str]:
        scope = "/".join(self.stack)
        stage = self._stages.get(scope)
        if stage is None:
            stage = self._stages[scope] = match_stage(scope)
        return stage, scope

    def _add(self, kind, name, reads, writes, fresh=(), attrs=None,
             extra_ins=(), lanes=None) -> Node:
        ins = [self.read(t) for t in reads] + list(extra_ins)
        # Per output, the values it reads (read before any write).
        edges = ([[self.read(t) for t in lane] for lane in lanes]
                 if lanes is not None else None)
        outs = []
        for j, t in enumerate(writes):
            vid, old = self.write(t)
            outs.append(vid)
            if old is not None:
                ins.append(old)
                if edges is not None:
                    edges[j].append(old)
        for t in fresh:
            vid, _ = self.write(t)
            outs.append(vid)
        attrs = attrs or {}
        if edges is not None:
            attrs["edges"] = tuple(tuple(e) for e in edges)
        stage, scope = self._stage()
        node = Node(idx=len(self.nodes), kind=kind, name=name, stage=stage,
                    scope=scope, ins=tuple(ins), outs=tuple(outs),
                    in_meta=tuple(_meta(t) for t in reads),
                    out_meta=tuple(_meta(t) for t in list(writes)
                                   + list(fresh)),
                    attrs=attrs)
        self.nodes.append(node)
        return node

    def op(self, func, args, kwargs, out) -> None:
        name = str(func)
        if func.namespace == "c10d":
            self._collective(func, args, kwargs)
            return
        self._p2p_sends = []
        reads, writes = [], []
        lists, singles = [], []
        for i, (arg, written) in enumerate(_schema_args(func)):
            v = args[i] if i < len(args) else kwargs.get(arg, None)
            ts = _flat_tensors(v)
            reads += ts
            if written:
                writes += ts
            (lists if isinstance(v, (list, tuple)) else singles).append(ts)
        in_keys = {_storage_key(t) for t in reads}
        written = {_storage_key(t) for t in writes}
        fresh = [t for t in _flat_tensors(out)
                 if _storage_key(t) not in in_keys
                 and _storage_key(t) not in written]
        attrs = {}
        if name == "aten.view.dtype":
            attrs = {"src": reads[0].dtype, "dst": args[1]}
        elif name.startswith("aten.sum") or name.startswith("aten.mean"):
            attrs = {"extent": reads[0].numel() // max(
                1, sum(t.numel() for t in _flat_tensors(out)) or 1)}
        elif name == "aten._to_copy.default":
            attrs = {"src": reads[0].dtype,
                     "dst": kwargs.get("dtype") or reads[0].dtype,
                     "sync": _blocking_to_host(
                         reads[0], kwargs.get("device"),
                         kwargs.get("non_blocking", False))}
        elif name == "aten.copy_.default":
            attrs = {"sync": _blocking_to_host(
                args[1], args[0].device,
                args[2] if len(args) > 2 else kwargs.get("non_blocking",
                                                         False))}
        lanes = None
        if name.startswith("aten._foreach_") and lists:
            # One edge a list element: output j reads element j of every
            # list argument and the op's single tensors.
            n = len(lists[0])
            if all(len(ts) == n for ts in lists) \
                    and len(writes) + len(fresh) == n:
                one = [t for ts in singles for t in ts]
                lanes = [[ts[j] for ts in lists] + one for j in range(n)]
        self._add("op", name, reads, writes, fresh, attrs, lanes=lanes)

    def _collective(self, func, args, kwargs) -> None:
        from torch._C._distributed_c10d import ProcessGroup

        short = func._schema.name.split("::")[-1]
        named = {}
        for i, a in enumerate(func._schema.arguments):
            named[a.name] = (args[i] if i < len(args)
                             else kwargs.get(a.name, a.default_value))
        written_names = _C10D_WRITES.get(short, ())
        writes = [t for n in written_names for t in _flat_tensors(named[n])]
        reads = [t for n, v in named.items() if n not in written_names
                 for t in _flat_tensors(v)]
        if short in ("allreduce_", "allreduce_coalesced_", "broadcast_"):
            reads = list(writes)          # in place: read, then written
        attrs: Dict[str, Any] = {}
        pg = named.get("process_group")
        if pg is not None:
            group = ProcessGroup.unbox(pg)
            attrs["ranks"] = tuple(dist.get_process_group_ranks(group))
            if short in ("send",):
                attrs["peer"] = dist.get_global_rank(group, int(named["dst"]))
            elif short in ("recv_",):
                attrs["peer"] = dist.get_global_rank(group, int(named["src"]))
        op = named.get("reduce_op")
        if op is not None:
            attrs["reduce_op"] = _reduce_op_name(op)
        operand = writes if short in ("allreduce_", "allreduce_coalesced_",
                                      "broadcast_", "recv_") else reads
        attrs["nbytes"] = sum(t.numel() * t.element_size() for t in operand)
        extra = ()
        if short in _P2P:
            if short == "send":
                extra = ()
            else:
                # A recv of a batch carries what the peers sent in it: the
                # program is the same on every rank, so it is what this
                # rank's sends of the batch hold (the JAX ppermute's edge).
                extra = tuple(self._p2p_sends)
        else:
            self._p2p_sends = []
        node = self._add("collective", f"c10d.{short}", reads, writes,
                         attrs=attrs, extra_ins=extra)
        if short == "send":
            self._p2p_sends += list(node.ins)

    def kernel(self, name: str, reads, written) -> None:
        self._p2p_sends = []
        fresh_keys = {_storage_key(t) for t in reads}
        writes = [t for t in written if _storage_key(t) in fresh_keys]
        fresh = [t for t in written if _storage_key(t) not in fresh_keys]
        self._add("kernel", name, reads, writes, fresh)

    def host_read(self, method: str, t: torch.Tensor):
        """Record a host read of ``t`` and return the stub it gets."""
        if self._quiet:
            req = HostRead(method, _package_site(), "", tuple(t.shape),
                           t.dtype)
            return _stub(method, req,
                         self.forced(req) if self.forced else None)
        stage, _scope = self._stage()
        req = HostRead(method=method, site=_package_site(), stage=stage,
                       shape=tuple(t.shape), dtype=t.dtype,
                       index=self.n_reads)
        self.n_reads += 1
        self._add("host_read", method, [t], [],
                  attrs={"method": method, "site": req.site,
                         "sync": t.device.type == "cuda",
                         "index": req.index})
        chosen = self.branch.reads(req) if self.branch.reads else None
        return _stub(method, req, chosen)

    def draw(self, key, method: str, shape, dtype: str) -> None:
        """Record one consumption of ``key`` (``core.LeafKey``'s hook)."""
        if self._quiet:
            return
        fields = tuple(key.fields)
        root = (("fields",) + fields if fields
                else ("const", int(key.seed), int(key.count)))
        lineage = root + (("leaf", int(key.leaf)),
                          ("folds", tuple(key.folds)))
        self._add("draw", f"draw.{method}", [], [],
                  attrs={"method": method, "shape": tuple(shape),
                         "dtype": dtype, "lineage": lineage,
                         "fields": fields, "derived": key.derived_seed()})

    def mark_scan(self, out) -> None:
        """Note ``out`` (a non-finite test's result) as the scan's."""
        for t in _flat_tensors(out):
            vid = self.current.get(_storage_key(t))
            if vid is not None:
                self.scans.add(vid)


def _blocking_to_host(src: torch.Tensor, device, non_blocking) -> bool:
    """Whether a copy of ``src`` to ``device`` is a blocking read of a
    card value on the host (a copy into pinned memory that does not block
    is not: the guard's and the ladder's reads wait on an event)."""
    return (src.device.type == "cuda" and device is not None
            and torch.device(device).type == "cpu" and not non_blocking)


def _reduce_op_name(op) -> str:
    try:
        code = int(op.op())
    except Exception:                                   # noqa: BLE001
        return "SUM"
    for name in ("SUM", "AVG", "PRODUCT", "MIN", "MAX", "BAND", "BOR",
                 "BXOR", "PREMUL_SUM"):
        if int(getattr(dist.ReduceOp.RedOpType, name)) == code:
            return name
    return "SUM"


_NP_DTYPES = {torch.bool: np.bool_, torch.uint8: np.uint8,
              torch.int8: np.int8, torch.int16: np.int16,
              torch.int32: np.int32, torch.int64: np.int64,
              torch.float16: np.float16, torch.bfloat16: np.float32,
              torch.float32: np.float32, torch.float64: np.float64}


def _np_dtype(dtype: torch.dtype):
    return _NP_DTYPES.get(dtype, np.float32)


def _stub(method: str, req: HostRead, chosen):
    dt = _np_dtype(req.dtype)
    arr = (np.zeros(req.shape, dt) if chosen is None
           else np.asarray(chosen, dtype=dt).reshape(req.shape))
    if method in ("numpy", "__array__"):
        return arr
    if method == "tolist":
        return arr.tolist()
    value = arr.reshape(-1)[0].item() if arr.size else 0
    if method == "__bool__":
        return bool(value)
    if method in ("__int__", "__index__"):
        return int(value)
    if method == "__float__":
        return float(value)
    if req.dtype == torch.bool:
        return bool(value)
    return value


class _DispatchRecorder(TorchDispatchMode):
    def __init__(self, rec: _Recorder):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = self.rec
        if func is torch.ops.aten._local_scalar_dense.default \
                and isinstance(args[0], FakeTensor):
            return rec.host_read("item", args[0])
        if str(func) in _SYNCING_OPS and not rec._quiet:
            raise RuntimeError(
                f"{func} has an output shape that depends on the data: on "
                "the card it waits for a count read back to the host")
        out = func(*args, **kwargs)
        if not rec._quiet:
            rec.op(func, args, kwargs, out)
        return out


_CPU = torch.device("cpu")


def _fake_cuda(x) -> List[FakeTensor]:
    if isinstance(x, FakeTensor):
        return [x] if x.fake_device.type == "cuda" else []
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _fake_cuda(v)]
    return []


class _FunctionMode(TorchFunctionMode):
    """Host reads of fake tensors (module docstring), and Python indexing
    of fake CUDA tensors: torch's indexing binding enters a CUDA device
    guard, which a build without CUDA lacks, so the indexing runs with the
    fake tensors' device set to the CPU, and its result is put back on the
    card (the ops it dispatches are the same)."""

    def __init__(self, rec: _Recorder):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _HOST_READ_METHODS and args \
                and isinstance(args[0], FakeTensor):
            return self.rec.host_read(name, args[0])
        if name in ("__getitem__", "__setitem__"):
            on_card = _fake_cuda(args)
            if on_card:
                return _on_host(func, args, kwargs, on_card)
        mark = self.rec.mark()
        try:
            out = func(*args, **kwargs)
        except RuntimeError as e:
            on_card = _fake_cuda(list(args) + list(kwargs.values()))
            if _NO_CUDA not in str(e) or not on_card:
                raise
            self.rec.rollback(mark)
            out = _on_host(func, args, kwargs, on_card)
        if name in _SCAN_FUNCS and not self.rec._quiet:
            # The test decomposes into plain comparisons; its result is
            # what the state passes call the non-finite scan.
            self.rec.mark_scan(out)
        return out


# The non-finite tests whose results the guard's bad flag descends from.
_SCAN_FUNCS = frozenset({"isfinite", "isnan", "isinf", "isposinf",
                         "isneginf"})


# What torch raises where a binding enters a CUDA device guard in a build
# without CUDA.
_NO_CUDA = "not linked with support for cuda devices"


def _on_host(func, args, kwargs, on_card):
    """``func`` run with the fake CUDA tensors ``on_card`` set to the
    CPU, and every fake tensor it returns put on the card."""
    device = on_card[0].fake_device
    for t in on_card:
        t.fake_device = _CPU
    try:
        out = func(*args, **kwargs)
    finally:
        for t in on_card:
            t.fake_device = device
    for t in _flat_tensors(out):
        if isinstance(t, FakeTensor) and t.fake_device.type == "cpu":
            t.fake_device = device
    return out


# -- the fake world --------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A default process group of the ``"fake"`` backend at ``world``
    ranks, this process being ``rank``, for the block's length; destroyed
    afterwards, and the communicators' cached subgroups of it dropped.
    Raises when a default group exists already: the tracer never shares
    one (a gloo test's or a training script's group stays untouched)."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError(
            "the static auditor traces over a fake process group of its "
            "own, and a default process group exists already; trace before "
            "init_process_group or after destroy_process_group, or run the "
            "audit in a process of its own (python -m "
            "grace_tpu_torch.analysis)")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from grace_tpu_torch import comm

    cached = set(comm._HIER_GROUPS)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        for key in set(comm._HIER_GROUPS) - cached:
            del comm._HIER_GROUPS[key]
        dist.destroy_process_group()


def _host_generator(key, device) -> torch.Generator:
    """``LeafKey``'s generator for a fake CUDA trace: a CPU generator (a
    CUDA one needs the CUDA library; fake draws read only its device
    type's shapes, not its numbers)."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(key.derived_seed())
    return gen


def _cuda_patches(device: str):
    """What a fake CUDA trace needs on a machine without a card: the
    collectives ask the device's capability (an H100's), and the codecs'
    random streams a generator on the device."""
    if device != "cuda":
        return contextlib.nullcontext()
    from grace_tpu_torch.core import LeafKey

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        torch.cuda, "get_device_capability", lambda *a, **k: (9, 0)))
    stack.enter_context(mock.patch.object(
        torch.cuda, "current_device", lambda: 0))
    stack.enter_context(mock.patch.object(LeafKey, "_generator",
                                          _host_generator))
    return stack


@contextlib.contextmanager
def _recording(branch: Branch, device: str):
    from grace_tpu_torch import core

    rec = _Recorder(branch)
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    prev = scopes.STAGE_STACK, _fake_ops.RECORDER, core.DRAW_RECORDER
    scopes.STAGE_STACK, _fake_ops.RECORDER, core.DRAW_RECORDER = \
        rec.stack, rec, rec
    try:
        with _cuda_patches(device), fake_mode, _DispatchRecorder(rec), \
                _FunctionMode(rec):
            yield rec
    finally:
        scopes.STAGE_STACK, _fake_ops.RECORDER, core.DRAW_RECORDER = prev


# -- the traced graph --------------------------------------------------------------

@dataclasses.dataclass
class TracedGraph:
    """One audited step: the record plus audit context.

    ``world`` is the size of the exchange (dp) axis, ``rank`` the traced
    rank (0 unless asked), ``mesh_axes`` the axis names (dp first) with
    ``axis_sizes``; rank ``r`` of a 2-D mesh sits at ``(r // fsdp, r %
    fsdp)``. ``seeds[axis][vid]``: the rank variance of each root value
    over each axis. ``grad_in``: the gradient (or batch) values, the
    dependence graph's bucket roots. ``state_in``/``state_out``: aligned
    ``(path, signature)`` lists of the transform state before and after
    the update (update traces only), ``state_replicated`` the replicated
    state tensors' ``(path, (shape, dtype))``. ``leaves_in``/
    ``leaves_out``: ``(path, identity)`` of the state before and after the
    step, a :class:`TensorRef` for a tensor and the value itself for a
    host leaf (train traces: ``params/...`` and ``grace/...``).
    ``guard_probe`` (guarded train traces): the guarded update's own
    state going in and coming out, settled under each verdict
    (:func:`trace_train_step`). ``scans``: the values of the step's
    non-finite tests. ``meta``: what findings report (``grace``,
    ``param_structs``, ...). :meth:`twin` is the same trace taken as the
    last rank."""

    name: str
    nodes: List[Node]
    values: Dict[int, Tuple[Tuple[int, ...], torch.dtype]]
    world: int
    device: str
    mesh_axes: Tuple[str, ...]
    axis_sizes: Dict[str, int]
    seeds: Dict[str, Dict[int, bool]]
    grad_in: List[int] = dataclasses.field(default_factory=list)
    state_in: List[Tuple[str, Tuple]] = dataclasses.field(
        default_factory=list)
    state_out: List[Tuple[str, Tuple]] = dataclasses.field(
        default_factory=list)
    state_replicated: List[Tuple[str, Tuple]] = dataclasses.field(
        default_factory=list)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    branch: str = "base"
    start: int = 0
    rank: int = 0
    leaves_in: List[Tuple[str, Any]] = dataclasses.field(
        default_factory=list)
    leaves_out: List[Tuple[str, Any]] = dataclasses.field(
        default_factory=list)
    guard_probe: Optional[Dict[str, Any]] = None
    scans: Set[int] = dataclasses.field(default_factory=set)
    # ``retrace(rank, reads)``: this trace again as ``rank``, its host
    # reads stubbed by ``reads``.
    retrace: Optional[Callable] = dataclasses.field(default=None,
                                                    repr=False)
    _twin: Any = dataclasses.field(default=None, repr=False)

    @property
    def step_nodes(self) -> List[Node]:
        """The traced step's nodes (``nodes`` begins with the warm-up
        steps' nodes, which the dataflows run through)."""
        return self.nodes[self.start:]

    @property
    def axis_name(self) -> str:
        return self.mesh_axes[0]

    @property
    def axes(self) -> Tuple[str, ...]:
        return self.mesh_axes

    @property
    def n_ranks(self) -> int:
        return math.prod(self.axis_sizes[a] for a in self.mesh_axes)

    def coords(self, r: int) -> Dict[str, int]:
        """Rank ``r``'s index along each mesh axis."""
        if len(self.mesh_axes) == 1:
            return {self.mesh_axes[0]: r}
        f = self.axis_sizes[self.mesh_axes[1]]
        return {self.mesh_axes[0]: r // f, self.mesh_axes[1]: r % f}

    def axis_line(self, axis: str) -> Tuple[int, ...]:
        """The traced rank's ranks along ``axis`` (the others fixed)."""
        me = self.coords(self.rank)
        return tuple(r for r in range(self.n_ranks)
                     if all(c == me[a] for a, c in self.coords(r).items()
                            if a != axis))

    def span(self, ranks: Sequence[int], axis: str) -> int:
        """How many indices along ``axis`` the ranks cover."""
        return len({self.coords(r)[axis] for r in ranks})

    def replicates(self, ranks: Sequence[int], axis: str) -> bool:
        """Whether a collective over ``ranks`` makes its result the same
        along ``axis``: the group holds the traced rank's whole line."""
        return set(self.axis_line(axis)) <= set(ranks)

    @property
    def host_reads(self) -> List[Node]:
        return [n for n in self.step_nodes if n.kind == "host_read"]

    @property
    def collectives(self) -> List[Node]:
        return [n for n in self.step_nodes if n.kind == "collective"]

    @property
    def kernels(self) -> List[Node]:
        return [n for n in self.step_nodes if n.kind == "kernel"]

    @property
    def syncs(self) -> List[Node]:
        """The nodes that make the host wait for the card: blocking
        device-to-host copies and host reads of device tensors (what
        ``torch.cuda.set_sync_debug_mode`` flags)."""
        return [n for n in self.step_nodes if n.attrs.get("sync")]

    @property
    def draws(self) -> List[Node]:
        """The step's ``LeafKey`` consumptions, in order."""
        return [n for n in self.step_nodes if n.kind == "draw"]

    def kernel_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for n in self.kernels:
            out[n.name] = out.get(n.name, 0) + 1
        return out

    def twin(self) -> Optional["TracedGraph"]:
        """This trace again as the rank at the other end of the world:
        ``n_ranks − 1`` for rank 0, else 0 (None at one rank), made once.
        Every host read gets the stub it got here, but a read of a value
        that varies by rank here, which gets another one (a bool flipped,
        a number plus one): what a host field or a branch computes from
        such a read then differs between the two traces. Raises what that
        trace raises."""
        if self.n_ranks == 1 or self.retrace is None:
            return None
        if self._twin is None:
            from grace_tpu_torch.analysis.passes import replication

            var = replication(self)
            varying = {n.attrs["index"] for n in self.nodes
                       if n.kind == "host_read"
                       and any(var[a].get(n.ins[0], False)
                               for a in self.axes)}
            other = self.n_ranks - 1 if self.rank != self.n_ranks - 1 \
                else 0
            self._twin = self.retrace(other, varying)
        return self._twin


def _perturbed(reads, varying):
    """A stub chooser: ``reads``' stubs, but for the reads whose index is
    in ``varying``, which get another value."""
    def choose(req: HostRead):
        chosen = reads(req) if reads is not None else None
        if req.index not in varying:
            return chosen
        dt = _np_dtype(req.dtype)
        arr = (np.zeros(req.shape, dt) if chosen is None
               else np.asarray(chosen, dtype=dt).reshape(req.shape))
        return ~arr if arr.dtype == np.bool_ else arr + 1
    return choose


def _retracer(entry, branch: Branch, **kwargs):
    """``retrace(rank, varying)`` of a trace made by ``entry(**kwargs)``
    under ``branch`` (:meth:`TracedGraph.twin`)."""
    def retrace(rank: int, varying):
        return entry(**kwargs, rank=rank, branch=dataclasses.replace(
            branch, reads=_perturbed(branch.reads, varying)))
    return retrace


def _ref(rec: "_Recorder", t: torch.Tensor) -> TensorRef:
    return TensorRef(_storage_key(t), rec.read(t))


def _identities(rec: "_Recorder", leaves) -> List[Tuple[str, Any]]:
    """``(path, TensorRef or host value)`` of ``state_leaves``' output."""
    return [(p, _ref(rec, x) if isinstance(x, torch.Tensor) else x)
            for p, x in leaves]


def _layout(world: int, fsdp: Optional[int], fsdp_axis: Optional[str]):
    """``(mesh_axes, axis_sizes, dp)`` of an audit world: 1-D, or dp×fsdp
    with ``dp = world // fsdp``."""
    if not fsdp_axis:
        return (DEFAULT_AXIS,), {DEFAULT_AXIS: world}, world
    f = int(fsdp) if fsdp else 2
    if world % f:
        raise ValueError(f"fsdp={f} does not divide the audit world {world}")
    return ((DEFAULT_AXIS, fsdp_axis),
            {DEFAULT_AXIS: world // f, fsdp_axis: f}, world // f)


def _empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def _struct_of(x):
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    shape, dtype = x
    return tuple(shape), dtype


def trace_fn(fn, args: Sequence[Any], *, world: int = 8,
             device: str = "cuda", varying: Optional[Sequence[bool]] = None,
             name: str = "fn", meta: Optional[dict] = None,
             mesh_axes: Optional[Sequence[Tuple[str, int]]] = None,
             varying_axes: Optional[Dict[str, Sequence[bool]]] = None,
             branch: Optional[Branch] = None,
             state: Optional[Sequence[str]] = None,
             host: Optional[Dict[str, Any]] = None,
             rank: int = 0) -> TracedGraph:
    """Trace ``fn(*tensors)`` as ``rank`` (default 0) of a fake world.

    ``args`` are tensors or ``(shape, dtype)`` pairs, made fake on
    ``device``; ``varying`` flags each as rank-varying (default: all, the
    conservative seed) and ``varying_axes`` per mesh axis. ``mesh_axes``
    (``((name, size), ...)``, dp first) traces over a 2-D mesh of
    ``dp·fsdp`` ranks instead of the 1-D ``(data, world)``. ``fn`` calls
    ``torch.distributed`` on the default (fake) group. The low-level entry
    the seeded-hazard tests use; config audits go through
    :func:`trace_update` and :func:`trace_train_step`.

    State, for the state passes: ``state`` names the first
    ``len(state)`` args as state leaves (paths as GraceState's:
    ``mem/w``, ``count``, ...); each leaves the step as the tensor ``fn``
    returns at its position, or else as the arg itself (written in place
    or not). ``host``: host leaves by path; ``fn`` is then called as
    ``fn(*tensors, fields)`` with a copy of it to update."""
    layout = (tuple((str(n), int(s)) for n, s in mesh_axes)
              if mesh_axes is not None else ((DEFAULT_AXIS, int(world)),))
    axes = tuple(a for a, _ in layout)
    sizes = dict(layout)
    n_ranks = math.prod(sizes.values())
    structs = [_struct_of(a) for a in args]
    mask = list(varying) if varying is not None else [True] * len(structs)
    if len(mask) != len(structs):
        raise ValueError(f"varying has {len(mask)} entries for "
                         f"{len(structs)} args")
    masks = {a: list(varying_axes[a]) if varying_axes and a in varying_axes
             else mask for a in axes}
    branch = branch or Branch()
    paths = list(state or ())
    with fake_world(n_ranks, rank), _recording(branch, device) as rec:
        with rec.quiet():
            tensors = [_empty(s, d, device) for s, d in structs]
        vids = [rec.root(t, f"arg{i}") for i, t in enumerate(tensors)]
        leaves_in = _identities(rec, zip(paths, tensors))
        fields = dict(host) if host is not None else None
        if fields is not None:
            leaves_in += sorted(fields.items())
            out = fn(*tensors, fields)
        else:
            out = fn(*tensors)
        outs = list(out) if isinstance(out, (tuple, list)) else []
        leaves_out = _identities(rec, (
            (p, outs[i] if i < len(outs)
             and isinstance(outs[i], torch.Tensor) else tensors[i])
            for i, p in enumerate(paths)))
        if fields is not None:
            leaves_out += sorted(fields.items())
    seeds = {a: {v: bool(m) for v, m in zip(vids, masks[a])} for a in axes}
    return TracedGraph(name=name, nodes=rec.nodes, values=rec.values,
                       world=sizes[axes[0]], device=device,
                       mesh_axes=axes, axis_sizes=sizes, seeds=seeds,
                       grad_in=list(vids), meta=dict(meta or {}),
                       branch=branch.label, rank=rank,
                       leaves_in=leaves_in, leaves_out=leaves_out,
                       scans=set(rec.scans),
                       retrace=_retracer(
                           trace_fn, branch, fn=fn, args=args, world=world,
                           device=device, varying=varying, name=name,
                           meta=meta, mesh_axes=mesh_axes,
                           varying_axes=varying_axes, state=state,
                           host=host))


# -- state flattening ------------------------------------------------------------

def state_leaves(state, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of every tensor and host scalar of a transform's
    state (a GraceState or a guard's state), paths ``/``-joined from the
    GraceState fields (``mem/0``, ``comp/1/q``, ``count``, ...)."""
    from grace_tpu_torch.resilience.guard import GuardState
    from grace_tpu_torch.transform import GraceState

    out: List[Tuple[str, Any]] = []

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            out.append((path, x))
        elif isinstance(x, GuardState):
            # The settled-or-not inner state (reading .inner would settle
            # a pending verdict: a host read).
            walk(x._inner, f"{path}inner/")
            for f in ("notfinite_count", "last_bad_step", "consecutive",
                      "fallback_remaining", "step"):
                walk(getattr(x, f), f"{path}{f}")
        elif isinstance(x, GraceState):
            for f in dataclasses.fields(x):
                if f.name == "world":
                    continue
                walk(getattr(x, f.name), f"{path}{f.name}")
        elif isinstance(x, (bool, int, float, np.integer, np.floating)):
            out.append((path, x))
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                walk(x[k], f"{path}/{k}")
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for k in x._fields:
                walk(getattr(x, k), f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}/{i}")
        elif x is not None and hasattr(x, "_asdict"):
            for k, v in x._asdict().items():
                walk(v, f"{path}/{k}")
        elif x is not None and dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{path}/{f.name}")

    walk(state, prefix)
    return out


def _signature(leaf) -> Tuple:
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""),
                leaf.device.type)
    return (type(leaf).__name__,)


def _field(path: str) -> str:
    parts = path.split("/")
    return parts[1] if parts[0] == "inner" and len(parts) > 1 else parts[0]


def _is_varying_field(path: str) -> bool:
    from grace_tpu_torch.transform import GRACE_VARYING_FIELDS
    return _field(path) in GRACE_VARYING_FIELDS


# -- configs --------------------------------------------------------------------

def _prepare_grace(grace, mesh_axes, sizes):
    """The Grace bundle to trace: built here, over the fake world (a
    params dict: a 2-D config binds the mesh's groups), with an explicit
    topology (detecting one is a collective a fake group cannot run)."""
    from grace_tpu_torch.core import Topology
    from grace_tpu_torch.helper import grace_from_params

    if isinstance(grace, dict):
        group = None
        if len(mesh_axes) == 2:
            from grace_tpu_torch.parallel import make_mesh
            group = make_mesh(tuple(sizes[a] for a in mesh_axes), mesh_axes)
        grace = grace_from_params(dict(grace), group=group)
    elif getattr(grace, "mesh", None) is not None and grace.mesh.is_2d \
            and not grace.mesh.bound:
        raise ValueError(
            "a 2-D (fsdp_axis) config binds its mesh's process groups when "
            "it is built: pass its params dict, which the tracer builds "
            "over the fake world's mesh")
    if hasattr(grace, "topology") and dataclasses.is_dataclass(grace):
        grace = dataclasses.replace(grace,
                                    topology=grace.topology or Topology())
    return grace


def _fsdp_axis(grace) -> Optional[str]:
    if isinstance(grace, dict):
        return grace.get("fsdp_axis") or None
    mesh = getattr(grace, "mesh", None)
    return mesh.fsdp_axis if mesh is not None and mesh.is_2d else None


def _apply_branch(state, branch: Branch):
    """``state`` (a GraceState or a guard's) set to ``branch``'s host
    fields."""
    from grace_tpu_torch.transform import set_fallback_flag
    if branch.fallback:
        state = set_fallback_flag(state, True)
    inner = getattr(state, "inner", state)
    if branch.rung is not None:
        if getattr(inner, "adapt", None) is None:
            raise ValueError(f"branch {branch.label!r} sets a ladder rung "
                             "but the config has no adapt ladder")
        inner.adapt.rung = int(branch.rung)
    if branch.count is not None:
        inner.count = int(branch.count)
    return state


def trace_update(grace, *, world: int = 8, params=None,
                 name: str = "update", meta: Optional[dict] = None,
                 fsdp: Optional[int] = None, device: str = "cuda",
                 branch: Optional[Branch] = None, rank: int = 0
                 ) -> TracedGraph:
    """Trace one ``GraceTransform.update`` (the whole pipeline, the escape
    and telemetry included) at ``world`` ranks, as ``rank`` (default 0).

    ``grace`` is a ``Grace`` bundle (``helper.grace_from_params``), an
    object with ``.transform(seed)`` and ``.communicator``, or a params
    dict built inside the fake world (the way to trace a 2-D config: its
    mesh binds the world's groups; ``fsdp`` (default 2) splits the
    ``world`` ranks into ``dp = world // fsdp`` exchange groups).
    ``params`` maps names to ``(shape, dtype)`` (default
    :func:`default_param_structs`). The state is ``init``'s, made without
    being recorded, then set to the ``branch``'s host branch; the
    gradients are fresh fake tensors like the parameters. ``device``:
    ``"cuda"`` traces the card's route (the kernel wrappers' fake
    branches), ``"cpu"`` the plain versions."""
    branch = branch or Branch()
    retrace = _retracer(trace_update, branch, grace=grace, world=world,
                        params=params, name=name, meta=meta, fsdp=fsdp,
                        device=device)
    mesh_axes, sizes, dp = _layout(world, fsdp, _fsdp_axis(grace))
    params = params if params is not None else default_param_structs()
    params = {k: _struct_of(v) for k, v in params.items()}
    with fake_world(math.prod(sizes.values()), rank), \
            _recording(branch, device) as rec:
        with rec.quiet():
            grace = _prepare_grace(grace, mesh_axes, sizes)
            tx = grace.transform(seed=0)
            named = {k: _empty(s, d, device) for k, (s, d) in params.items()}
            state = _apply_branch(tx.init(named), branch)
            grads = {k: _empty(s, d, device) for k, (s, d) in params.items()}
            models = None
            if meta is None or "grace" not in meta:
                # The audited config's own footprint model, per rank and
                # at the world, while its groups live (a 2-D config's
                # mesh dies with the world).
                from grace_tpu_torch.analysis.flow import footprint_model
                try:
                    models = (footprint_model(grace, params),
                              footprint_model(grace, params, world=dp))
                except Exception:                        # noqa: BLE001
                    models = None      # not a Grace bundle: no model
        seeds: Dict[str, Dict[int, bool]] = {a: {} for a in mesh_axes}
        for path, x in state_leaves(state):
            if isinstance(x, torch.Tensor):
                vid = rec.root(x, path)
                for a in mesh_axes:
                    seeds[a][vid] = _is_varying_field(path)
        from grace_tpu_torch.transform import leaf_order
        for k in leaf_order(grads):
            vid = rec.root(grads[k], f"grad/{k}")
            for a in mesh_axes:
                seeds[a][vid] = True
        # Warm-up steps are recorded too (what they leave pending is read
        # in the traced step, with its variance), before the step's start.
        for _ in range(branch.warmup):
            _, state = tx.update(grads, state)
        start = len(rec.nodes)
        leaves = state_leaves(state)
        state_in = [(p, _signature(x)) for p, x in leaves]
        replicated = [(p, (tuple(x.shape), x.dtype)) for p, x in leaves
                      if isinstance(x, torch.Tensor)
                      and not _is_varying_field(p)]
        grad_in = [rec.read(grads[k]) for k in leaf_order(grads)]
        leaves_in = _identities(rec, leaves)
        _updates, new_state = tx.update(grads, state)
        leaves = state_leaves(new_state)
        state_out = [(p, _signature(x)) for p, x in leaves]
        leaves_out = _identities(rec, leaves)
    given = meta is not None and "grace" in meta
    meta = dict(meta or {})
    meta.setdefault("grace", grace)
    if not given and models is not None:
        meta["footprint_model"], meta["footprint_model_world"] = models
    return TracedGraph(name=name, nodes=rec.nodes, values=rec.values,
                       world=dp, device=device,
                       mesh_axes=mesh_axes, axis_sizes=sizes, seeds=seeds,
                       grad_in=grad_in, state_in=state_in,
                       state_out=state_out, state_replicated=replicated,
                       meta=meta, branch=branch.label, start=start,
                       rank=rank, leaves_in=leaves_in,
                       leaves_out=leaves_out, scans=set(rec.scans),
                       retrace=retrace)


class _AuditModel(torch.nn.Module):
    """The JAX package's audit model: ``x @ w + b[:classes]`` under the
    softmax cross-entropy, over the default parameters."""

    def __init__(self, device):
        super().__init__()
        (_, w_shape), (_, b_shape) = _DEFAULT_PARAMS
        self.w = torch.nn.Parameter(_empty(w_shape, torch.float32, device))
        self.b = torch.nn.Parameter(_empty(b_shape, torch.float32, device))

    @property
    def classes(self) -> int:
        return self.w.shape[1]


def _audit_loss(model: _AuditModel, batch) -> torch.Tensor:
    x, y = batch
    logits = x @ model.w + model.b[:model.classes]
    return torch.nn.functional.cross_entropy(logits, y)


class _StructModel(torch.nn.Module):
    """Parameters of the given ``{dotted name: (shape, dtype)}`` (nested
    modules, so that they keep their names) under :func:`_struct_loss`:
    a model's leaves without its layers."""

    def __init__(self, params, device):
        super().__init__()
        for name, (shape, dtype) in params.items():
            *path, leaf = name.split(".")
            mod = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, torch.nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(leaf, torch.nn.Parameter(
                _empty(shape, dtype, device)))


def _struct_loss(model: _StructModel, batch) -> torch.Tensor:
    """Every parameter's square sum scaled by the batch's mean: each
    gradient reads its parameter and the (rank-varying) batch."""
    x, _y = batch
    return sum(p.float().square().sum()
               for p in model.parameters()) * x.mean()


def _gradient_roots(model: torch.nn.Module, loss_fn, rec: _Recorder,
                    grads: Dict[str, int]):
    """``loss_fn`` with two hooks on the backward pass. Each parameter's
    gradient value is noted in ``grads`` as it lands (a post-accumulate
    hook): the exchange's bucket roots, as the JAX package's gradient
    leaves are. And fake CUDA parameters run the forward and backward as
    fake CPU tensors: torch's autograd enters a CUDA device guard that a
    build without CUDA lacks; each parameter and its gradient go back to
    the card as the gradient lands, so the exchange, the optimizer and the
    audit run on the card's route."""
    named = dict(model.named_parameters())
    on_card = [p for p in named.values()
               if isinstance(p, FakeTensor) and p.fake_device.type == "cuda"]
    device = on_card[0].fake_device if on_card else None

    def landed(name):
        def hook(p):
            if device is not None:
                # On the card the parameter takes no further autograd
                # (the optimizer and the audit run without it).
                p.fake_device = device
                p.grad.fake_device = device
                p.requires_grad_(False)
            grads[name] = rec.read(p.grad)
        return hook

    for name, p in named.items():
        p.register_post_accumulate_grad_hook(landed(name))

    def loss(m, batch):
        for p in on_card:
            p.fake_device = _CPU
            p.requires_grad_(True)
        return loss_fn(m, batch)

    return loss


class _GuardProbe:
    """A guarded chain whose ``apply`` is observed once armed
    (:func:`trace_train_step`): the state it takes and the state it
    returns, that state settled under a bad and under a good verdict
    (the verdict's read stubbed quietly: the step's own read, later,
    is recorded as always), and the verdict flags' value."""

    _VERDICTS = (("bad", (1, 0)), ("good", (0, 1)))

    def __init__(self, tx, rec: "_Recorder"):
        self._tx, self._rec = tx, rec
        self.armed = False
        self.probe: Optional[Dict[str, Any]] = None

    def __getattr__(self, name):
        return getattr(self._tx, name)

    def apply(self, params, grads, state, optimizer):
        from grace_tpu_torch.resilience.guard import _COUNTERS, GuardState

        if not self.armed:
            return self._tx.apply(params, grads, state, optimizer)
        rec = self._rec
        state.settle()                  # what apply does first
        probe = {"in": _identities(rec, _step_leaves(params, optimizer,
                                                     state))}
        out = self._tx.apply(params, grads, state, optimizer)
        probe["out"] = _identities(rec, _step_leaves(params, optimizer, out))
        pending = out._pending
        probe["flags"] = rec.read(pending.flags.host)
        saved = {p: dict(st) for p, st in optimizer.state.items()}
        for label, flags in self._VERDICTS:
            settled = GuardState(inner=out._inner, pending=pending,
                                 host_step=out.host_step,
                                 **{n: getattr(out, n) for n in _COUNTERS})
            rec.forced = _verdict_stub(flags)
            try:
                with rec.quiet():
                    settled.settle()
            finally:
                rec.forced = None
            probe[label] = _identities(rec, _step_leaves(params, optimizer,
                                                         settled))
            for p, st in saved.items():      # a bad verdict's restores
                optimizer.state[p].clear()
                optimizer.state[p].update(st)
        self.probe = probe
        return out


# The guard's read of its [bad, fallback] pair (passes.HOST_READ_CONTRACT).
GUARD_READ_SITE = "resilience/guard.py:read"


def _verdict_stub(flags):
    """A stub chooser giving the guard's read ``flags``: the whole pair,
    or one element a read (``tolist`` of a fake tensor reads each)."""
    left = list(flags)

    def choose(req: HostRead):
        if req.site != GUARD_READ_SITE:
            return None
        if req.shape:
            return np.asarray(flags)
        return left.pop(0)
    return choose


def _step_leaves(params, optimizer, grace_state) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of a train step's state: ``params/<name>``,
    ``opt/<name>/<key>`` (the optimizer's per-parameter state) and
    ``grace/...`` (:func:`state_leaves`)."""
    out: List[Tuple[str, Any]] = []
    for name, p in params.items():
        out.append((f"params/{name}", p))
        for key, v in sorted(optimizer.state.get(p, {}).items()):
            out.append((f"opt/{name}/{key}", v))
    return out + state_leaves(grace_state, "grace/")


def trace_train_step(grace, *, world: int = 8, guard: Optional[dict] = None,
                     consensus=None, name: str = "train_step",
                     meta: Optional[dict] = None, fsdp: Optional[int] = None,
                     device: str = "cuda", branch: Optional[Branch] = None,
                     rank: int = 0, params=None) -> TracedGraph:
    """Trace one ``train.make_train_step`` step (forward and backward, the
    exchange, SGD(0.1), the optional guard and the consensus audit) at
    ``world`` ranks, as ``rank`` (default 0), on the JAX package's audit
    model with a local batch of 4 rows. ``guard``: ``guarded_chain``'s
    keyword arguments (None: no guard); ``consensus``: the audit's config.
    A ``branch`` with ``audit=True`` places the step on the audit clock's
    boundary; ``fallback=True`` opens the escape window. With a guard, the
    traced step's ``GuardTransform.apply`` is probed (``guard_probe``).
    ``params`` (``{name: (shape, dtype)}``, e.g. ResNet-50's 161 leaves)
    replaces the audit model by a model of those leaves alone, whose loss
    makes each gradient read its parameter and the batch."""
    from grace_tpu_torch.resilience import guarded_chain
    from grace_tpu_torch.resilience.consensus import normalize_consensus
    from grace_tpu_torch.train import TrainState, make_train_step

    branch = branch or Branch()
    retrace = _retracer(trace_train_step, branch, grace=grace, world=world,
                        guard=guard, consensus=consensus, name=name,
                        meta=meta, fsdp=fsdp, device=device, params=params)
    mesh_axes, sizes, dp = _layout(world, fsdp, _fsdp_axis(grace))
    (_, (dim, classes)), _ = _DEFAULT_PARAMS
    with fake_world(math.prod(sizes.values()), rank), \
            _recording(branch, device) as rec:
        with rec.quiet():
            grace = _prepare_grace(grace, mesh_axes, sizes)
            tx = (_GuardProbe(guarded_chain(grace, seed=0, **guard), rec)
                  if guard is not None else grace.transform(seed=0))
            if params is None:
                model, loss_fn = _AuditModel(device), _audit_loss
            else:
                model = _StructModel({k: _struct_of(v)
                                      for k, v in params.items()}, device)
                loss_fn = _struct_loss
            optimizer = torch.optim.SGD(model.parameters(), lr=0.1)
            named = dict(model.named_parameters())
            with torch.no_grad():      # no autograd on fake CUDA tensors
                grace_state = _apply_branch(tx.init(named), branch)
            cfg = normalize_consensus(consensus)
            if branch.audit and cfg is not None:
                # The step that follows lands on the audit clock's boundary.
                if guard is not None:
                    grace_state.host_step = cfg.audit_every - 1
                else:
                    grace_state.count = cfg.audit_every - 1
            # The batch feeds the forward only (on the host's route, see
            # _gradient_roots).
            x = _empty((4, dim), torch.float32, _CPU)
            y = _empty((4,), torch.int64, _CPU)
        mesh = getattr(grace, "mesh", None)
        grad_vids: Dict[str, int] = {}
        step = make_train_step(_gradient_roots(model, loss_fn, rec,
                                               grad_vids), tx,
                               consensus=consensus,
                               mesh=mesh if mesh is not None
                               and mesh.bound else None)
        seeds: Dict[str, Dict[int, bool]] = {a: {} for a in mesh_axes}
        for pname, p in named.items():
            vid = rec.root(p, f"params/{pname}")
            for a in mesh_axes:
                seeds[a][vid] = False
        for path, leaf in state_leaves(grace_state, "grace/"):
            if isinstance(leaf, torch.Tensor):
                vid = rec.root(leaf, path)
                vary = _is_varying_field(path[len("grace/"):])
                for a in mesh_axes:
                    seeds[a][vid] = vary
        for label, t in (("batch/x", x), ("batch/y", y)):
            vid = rec.root(t, label)
            for a in mesh_axes:
                # Both fsdp shards of a dp row read the same rows.
                seeds[a][vid] = a == mesh_axes[0]
        state = TrainState(model, optimizer, grace_state)
        # Warm-up steps are recorded too, before the traced step's start.
        for _ in range(branch.warmup):
            state, _ = step(state, (x, y))
        start = len(rec.nodes)
        grad_vids.clear()
        leaves_in = _identities(rec, _step_leaves(named, optimizer,
                                                  state.grace))
        if guard is not None:
            tx.armed = True
        state, _ = step(state, (x, y))
        leaves_out = _identities(rec, _step_leaves(named, optimizer,
                                                   state.grace))
        from grace_tpu_torch.transform import leaf_order
        grad_in = [grad_vids[k] for k in leaf_order(grad_vids)]
    meta = dict(meta or {})
    meta.setdefault("grace", grace)
    meta.setdefault("guard", guard)
    meta.setdefault("consensus", consensus)
    return TracedGraph(name=name, nodes=rec.nodes, values=rec.values,
                       world=dp, device=device,
                       mesh_axes=mesh_axes, axis_sizes=sizes, seeds=seeds,
                       grad_in=grad_in, meta=meta, branch=branch.label,
                       start=start, rank=rank, leaves_in=leaves_in,
                       leaves_out=leaves_out,
                       guard_probe=tx.probe if guard is not None else None,
                       scans=set(rec.scans), retrace=retrace)
