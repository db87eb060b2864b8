"""The four audit passes over a recorded step; counterpart of the JAX
package's ``analysis/passes.py``.

Every pass takes a :class:`~grace_tpu_torch.analysis.trace.TracedGraph`
and returns a list of :class:`Finding`. The trace is one rank's program in
order (no branches: a host branch is a trace of its own), so each dataflow
is one forward sweep over its nodes:

* **replication** — a value varies by rank over a mesh axis when it
  descends from a value seeded so (gradients, the batch, GraceState's
  per-rank fields), and is the same on every rank again after a
  collective whose group holds the traced rank's whole line along the
  axis (a full all-reduce, all-gather or broadcast); a ``recv_`` or an
  all-to-all makes its output vary over the axes its group spans;
* **stage attribution** — each node carries the ``grace/...`` stage it
  ran under (:func:`grace_tpu_torch.telemetry.scopes.trace_stage`), so
  findings name the pipeline stage.

The port's form of JAX's ``lax.cond`` on a rank-varying predicate is a
host read of a rank-varying value ahead of a collective: the Python branch
it feeds can take different ways on different ranks, and their collective
sequences part (``collective_consistency``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from grace_tpu_torch.analysis.trace import Node, TracedGraph

__all__ = ["Finding", "PASS_NAMES", "run_passes", "HOST_READ_CONTRACT",
           "pass_collective_consistency", "pass_bit_exactness",
           "pass_wire_reconciliation", "pass_signature_stability",
           "collective_signature", "count_recv_bytes",
           "count_recv_link_bytes", "replication", "device_reads"]

# The c10d ops by behaviour class.
_REDUCTIONS = frozenset({"c10d.allreduce_", "c10d.allreduce_coalesced_",
                         "c10d._reduce_scatter_base_",
                         "c10d.reduce_scatter_",
                         "c10d.reduce_scatter_tensor_coalesced_"})
_GATHERS = frozenset({"c10d._allgather_base_", "c10d.allgather_",
                      "c10d.allgather_into_tensor_coalesced_"})
_BROADCASTS = frozenset({"c10d.broadcast_"})
_RECVS = frozenset({"c10d.recv_", "c10d.recv_any_source_"})
_SENDS = frozenset({"c10d.send"})
_ALLTOALL = frozenset({"c10d.alltoall_base_", "c10d.alltoall_"})
_SCATTERS = frozenset({"c10d._reduce_scatter_base_", "c10d.reduce_scatter_",
                       "c10d.reduce_scatter_tensor_coalesced_"})

# The JAX package's ten passes, in its order: flow.py holds 5-7 and
# state_passes.py 8-10 (both resolved lazily: they import this module).
PASS_NAMES = ("collective_consistency", "bit_exactness",
              "wire_reconciliation", "signature_stability",
              "overlap_schedulability", "numeric_safety",
              "memory_footprint", "rng_lineage", "rollback_coverage",
              "replication_contract")

# The host reads the port's contract names, by the site that makes them
# (``<module>:<function>``): each reads a value that every rank holds
# alike, at a point the port documents.
HOST_READ_CONTRACT = {
    "resilience/guard.py:read":
        "the guard's settle read of [bad, fallback] after the mesh-wide OR",
    "resilience/consensus.py:_audit":
        "the consensus audit's read of the gathered fingerprint matrix",
    "resilience/consensus.py:_repair":
        "the consensus repair's read of the broadcast host fields",
    "resilience/adapt.py:read":
        "the adaptive ladder's window read at a boundary",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One finding. ``severity`` is ``'error'`` or ``'warning'``;
    ``stage`` the ``grace/...`` stage of the offending op (empty when
    unattributable). The JAX package's record."""

    pass_name: str
    config: str
    severity: str
    message: str
    stage: str = ""
    details: Tuple[Tuple[str, Any], ...] = ()

    def as_dict(self) -> dict:
        return {"pass": self.pass_name, "config": self.config,
                "severity": self.severity, "message": self.message,
                "stage": self.stage, **dict(self.details)}


def _along(traced: TracedGraph, node: Node, axis: str) -> bool:
    """Whether a collective's group spans ``axis`` (two of its ranks sit
    at different indices along it); a p2p op's peer does."""
    peer = node.attrs.get("peer")
    if peer is not None:
        return traced.span((traced.rank, peer), axis) > 1
    return traced.span(node.attrs.get("ranks", ()), axis) > 1


def _on_exchange_axis(traced: TracedGraph, node: Node) -> bool:
    return node.kind == "collective" and _along(traced, node,
                                                traced.axis_name)


# ---------------------------------------------------------------------------
# replication (rank-variance) dataflow
# ---------------------------------------------------------------------------

def replication(traced: TracedGraph) -> Dict[str, Dict[int, bool]]:
    """Per axis, whether each value varies by rank along it (module
    docstring). Values no node wrote and no seed names are constants made
    outside the step: replicated."""
    out = {}
    for axis in traced.axes:
        var = dict(traced.seeds.get(axis, {}))
        for node in traced.nodes:
            if node.kind != "collective":
                # Per output: a _foreach_ op's element j reads its own
                # list elements.
                for j, v in enumerate(node.outs):
                    var[v] = any(var.get(u, False) for u in node.sources(j))
                continue
            any_in = any(var.get(v, False) for v in node.ins)
            ranks = node.attrs.get("ranks", ())
            name = node.name
            if name in _SENDS:
                continue
            if name in _RECVS or name in _ALLTOALL or name in _SCATTERS:
                flag = _along(traced, node, axis) or any_in
            elif traced.replicates(ranks, axis):
                flag = False
            else:
                flag = any_in
            for v in node.outs:
                var[v] = flag
        out[axis] = var
    return out


# ---------------------------------------------------------------------------
# pass 1: collective consistency across host branches
# ---------------------------------------------------------------------------

def collective_signature(traced: TracedGraph) -> Tuple:
    """Ordered ``(op, group ranks or peer, operand shapes/dtypes)`` of
    every collective of the trace: two host branches with equal
    signatures issue the same collective sequence."""
    sig = []
    for n in traced.collectives:
        where = (("peer", n.attrs["peer"]) if "peer" in n.attrs
                 else ("ranks", tuple(n.attrs.get("ranks", ()))))
        sig.append((n.name, where, tuple((tuple(s), str(d)) for s, d
                                         in n.in_meta or n.out_meta),
                    n.attrs.get("reduce_op", "")))
    return tuple(sig)


def device_reads(traced: TracedGraph) -> List[Node]:
    """The host reads of values the step computed from its state, its
    gradients or its batch (a read of host bookkeeping made into a tensor
    is not one)."""
    derived = set()
    roots = set()
    for seeds in traced.seeds.values():
        roots |= set(seeds)
    derived |= roots
    out = []
    for node in traced.nodes:
        hit = any(v in derived for v in node.ins)
        if node.kind == "host_read":
            if hit and node.idx >= traced.start:
                out.append(node)
            continue
        if hit:
            derived.update(node.outs)
    return out


def pass_collective_consistency(traced: TracedGraph) -> List[Finding]:
    """A host read of a value that varies by rank, ahead of a collective
    that spans an axis it varies over, in the same step: the Python branch
    the value feeds may part the ranks' collective sequences (the JAX
    package's divergent ``lax.cond`` under a rank-varying predicate, the
    cross-rank deadlock class). Replication regained through a full
    collective blesses the read: the guard's settle read of the mesh-wide
    OR, the audit's read of the gathered fingerprint matrix."""
    findings: List[Finding] = []
    var = replication(traced)
    nodes = traced.nodes
    for h in traced.host_reads:
        v = h.ins[0]
        bad = [a for a in traced.axes if var[a].get(v, False)]
        if not bad:
            continue
        later = [n for n in nodes[h.idx + 1:]
                 if n.kind == "collective"
                 and any(_along(traced, n, a) for a in bad)]
        if not later:
            continue
        findings.append(Finding(
            pass_name="collective_consistency", config=traced.name,
            severity="error", stage=h.stage,
            message=(
                f"host read '{h.attrs['method']}' at "
                f"{h.attrs['site']} of a value that varies by rank over "
                f"{bad} precedes {len(later)} collective(s) "
                f"(first: {later[0].name} in {later[0].stage or '?'}) — "
                "a Python branch on it can take different ways on "
                "different ranks, and the ranks that must rendezvous "
                "deadlock or desync at the first mismatched collective"),
            details=(("world", traced.world), ("varying_axes", tuple(bad)),
                     ("site", h.attrs["site"]),
                     ("branch", traced.branch))))
    return findings


# ---------------------------------------------------------------------------
# pass 2: bit-exactness of cross-rank reductions
# ---------------------------------------------------------------------------

def _is_float(dtype) -> bool:
    return dtype.is_floating_point if isinstance(dtype, torch.dtype) \
        else False


def pass_bit_exactness(traced: TracedGraph) -> List[Finding]:
    """Bit-pattern data must never ride a float-space cross-rank
    reduction (``-0.0 + 0.0 == +0.0`` flips sign bits, NaN payloads are
    not kept through float adds). Taint: a float value read through an
    integer dtype view (fingerprint words, the guard's integer views,
    masked-broadcast words) makes its op's outputs bit-pattern data, kept
    through arithmetic and conversions; an integer value read through a
    float view is a float again. A float all-reduce (or reduce-scatter)
    over tainted data is the finding; integer reductions
    (``comm.masked_broadcast_``) and gathers are the sanctioned ways."""
    findings: List[Finding] = []
    taint: Dict[int, bool] = {}

    def tainted(v, read_dtype) -> bool:
        value_dtype = traced.values.get(v, ((), read_dtype))[1]
        if _is_float(value_dtype) and not _is_float(read_dtype):
            return True               # a float's bits read as integers
        if not _is_float(value_dtype) and _is_float(read_dtype):
            return False              # integers read back as a float
        return taint.get(v, False)

    for node in traced.nodes:
        flags = [tainted(v, meta[1])
                 for v, meta in zip(node.ins, node.in_meta)]
        flags += [taint.get(v, False) for v in node.ins[len(node.in_meta):]]
        out = any(flags)
        if node.kind == "collective" and node.name in _REDUCTIONS \
                and node.idx >= traced.start \
                and _along(traced, node, traced.axis_name) \
                and any(f and _is_float(meta[1])
                        for f, meta in zip(flags, node.in_meta)):
            findings.append(Finding(
                pass_name="bit_exactness", config=traced.name,
                severity="error", stage=node.stage,
                message=(
                    f"float-dtype {node.name} "
                    f"({node.attrs.get('reduce_op', 'SUM')}) over "
                    "bit-pattern data (a float value's bits read as "
                    "integers: fingerprint/checksum/masked-broadcast "
                    "words) — float adds alias -0.0/+0.0 and drop NaN "
                    "payloads; reduce in integer bit space "
                    "(comm.masked_broadcast_) instead"),
                details=(("world", traced.world),)))
        for v in node.outs:
            taint[v] = out
    return findings


# ---------------------------------------------------------------------------
# pass 3: wire-byte reconciliation against Communicator.recv_wire_bytes
# ---------------------------------------------------------------------------

def _group_size(traced: TracedGraph, node: Node) -> int:
    """Ranks one collective spans along the exchange axis."""
    return traced.span(node.attrs.get("ranks", ()), traced.axis_name)


def _dp_index(traced: TracedGraph, r: int) -> int:
    return traced.coords(r)[traced.axis_name]


def _link_tier(traced: TracedGraph, node: Node, topology) -> int:
    """Worst link tier a collective's traced rank set touches under
    ``topology``: 0 = ICI (intra-slice), 1 = DCN (cross-slice), 2 = WAN
    (cross-region); the JAX package's attribution over exchange-axis
    indices. A p2p op crosses a boundary iff its peer sits on the other
    side of the traced rank; a group crosses iff its members do."""
    world = traced.world
    if topology is None or not topology.crosses_dcn(world):
        return 0
    spans = [topology.slice_size]
    if topology.region_size is not None and topology.crosses_wan(world):
        spans.append(topology.region_size)
    peer = node.attrs.get("peer")
    members = ((traced.rank, peer) if peer is not None
               else node.attrs.get("ranks", ()))
    idx = {_dp_index(traced, r) for r in members}
    tier = 0
    for i, span in enumerate(spans, start=1):
        if len({j // span for j in idx}) > 1:
            tier = i
    return tier


def _recv_bytes(traced: TracedGraph, node: Node) -> int:
    """Bytes one rank receives in one collective, by the schedules the
    wire model assumes: a ring all-reduce moves ``2·n·(G-1)/G``, a gather
    receives every other member's shard ``n·(G-1)``, a ``recv_`` its
    buffer, a broadcast its tensor, an all-to-all or reduce-scatter
    ``n·(G-1)/G``; a ``send`` receives nothing."""
    n = node.attrs.get("nbytes", 0)
    name = node.name
    if name in _SENDS:
        return 0
    if name in _RECVS or name in _BROADCASTS:
        return n
    g = _group_size(traced, node)
    if name in _GATHERS:
        return n * max(0, g - 1)
    if name in _ALLTOALL or name in _SCATTERS:
        return n * (g - 1) // max(1, g)
    return 2 * n * (g - 1) // max(1, g)


def count_recv_bytes(traced: TracedGraph) -> int:
    """Bytes received per rank by the step's collectives along the
    exchange axis: the scalar view of :func:`count_recv_link_bytes`."""
    return sum(count_recv_link_bytes(traced, None))


def count_recv_link_bytes(traced: TracedGraph, topology
                          ) -> Tuple[int, int, int]:
    """Per-rank received bytes of the step's exchange-axis collectives,
    split into ``(ici, dcn, wan)`` by the worst boundary each one's rank
    set crosses under ``topology`` (None: all ICI)."""
    tiers = [0, 0, 0]
    for node in traced.collectives:
        if not _along(traced, node, traced.axis_name):
            continue
        tiers[_link_tier(traced, node, topology)] += _recv_bytes(traced,
                                                                 node)
    return tiers[0], tiers[1], tiers[2]


def _param_structs(traced: TracedGraph):
    from grace_tpu_torch.analysis.trace import default_param_structs
    named = traced.meta.get("param_structs")
    return dict(named) if named is not None else default_param_structs()


def wire_model(traced: TracedGraph):
    """``(model_link_at, model, comp_b, label)`` of the trace's config:
    the communicator's (or, routed, the per-leaf) wire model."""
    from grace_tpu_torch.core import Topology, negotiation_bytes_for
    from grace_tpu_torch.transform import (fusion_payload_nbytes,
                                           fusion_payload_structs)

    grace = traced.meta["grace"]
    named = _param_structs(traced)
    leaves = list(named.values())
    world = traced.world
    if getattr(grace, "routes", None):
        from grace_tpu_torch.helper import routed_recv_link_bytes

        def model_link_at(topo):
            return routed_recv_link_bytes(grace, named, world,
                                          topology=topo)

        return model_link_at, model_link_at(None).total, None, \
            "routed per-leaf model"
    _, comp_b, n_elems = fusion_payload_nbytes(grace.compressor, leaves,
                                               grace.fusion)
    vote = bool(getattr(grace.compressor, "vote_aggregate", False))
    neg_b = sum(count * negotiation_bytes_for(
        grace.compressor, math.prod(shape), world)
        for (shape, _dt), count in fusion_payload_structs(leaves,
                                                          grace.fusion))

    def model_link_at(topo):
        lb = grace.communicator.recv_link_bytes(comp_b, n_elems, world,
                                                topology=topo, vote=vote)
        if not neg_b:
            return lb
        t = topo if topo is not None else Topology()
        tier = t.flat_tier(world)
        return lb._replace(**{tier: getattr(lb, tier) + neg_b})

    model = grace.communicator.recv_wire_bytes(comp_b, n_elems, world,
                                               vote=vote) + neg_b
    return (model_link_at, model, comp_b,
            f"{type(grace.communicator).__name__}.recv_wire_bytes")


def pass_wire_reconciliation(traced: TracedGraph) -> List[Finding]:
    """The bytes each rank receives, counted from the step's c10d ops,
    against the wire model that telemetry and the examples trust
    (``Communicator.recv_wire_bytes``/``recv_link_bytes``, or the routed
    per-leaf ``helper.routed_recv_link_bytes``), within
    ``core.WIRE_MODEL_RTOL``/``WIRE_MODEL_ATOL``; then the model's
    per-link split against its scalar under three layouts, and against
    the counted split under the communicator's own (or a halved) slice.
    Needs ``meta['grace']``: a no-op on traces without a model."""
    from grace_tpu_torch.core import (WIRE_MODEL_ATOL, WIRE_MODEL_RTOL,
                                      Topology)

    grace = traced.meta.get("grace")
    if grace is None or not hasattr(grace, "communicator"):
        return []
    model_link_at, model, comp_b, comm_name = wire_model(traced)
    counted = count_recv_bytes(traced)
    tol = max(WIRE_MODEL_RTOL * max(model, counted), WIRE_MODEL_ATOL)
    if abs(counted - model) > tol:
        return [Finding(
            pass_name="wire_reconciliation", config=traced.name,
            severity="error", stage="grace/exchange",
            message=(
                f"{comm_name} models {model} B/rank/step but the traced "
                f"step moves {counted} B (world={traced.world}, "
                f"payload={comp_b} B) — drift {abs(counted - model)} B "
                f"exceeds the documented tolerance (rtol={WIRE_MODEL_RTOL},"
                f" atol={WIRE_MODEL_ATOL} B); telemetry wire_bytes and the "
                "examples' projections are wrong"),
            details=(("model_bytes", int(model)),
                     ("counted_bytes", int(counted)),
                     ("world", traced.world)))]
    world = traced.world
    half = max(1, world // 2)
    topos = [None, Topology(slice_size=half)]
    if world >= 4:
        topos.append(Topology(slice_size=max(1, world // 4),
                              region_size=half))
    for topo in topos:
        link = model_link_at(topo)
        if link.total != model:
            return [Finding(
                pass_name="wire_reconciliation", config=traced.name,
                severity="error", stage="grace/exchange",
                message=(
                    f"{comm_name} splits into ici={link.ici} + "
                    f"dcn={link.dcn} + wan={link.wan} = {link.total} B "
                    f"under topology {topo!r}, but the scalar model says "
                    f"{model} B — the per-link breakdown and the scalar "
                    "model must be one implementation"),
                details=(("model_bytes", int(model)),
                         ("ici_bytes", int(link.ici)),
                         ("dcn_bytes", int(link.dcn)),
                         ("wan_bytes", int(link.wan)),
                         ("world", world)))]
    own_slice = getattr(grace.communicator, "slice_size", None)
    own_region = getattr(grace.communicator, "region_size", None)
    audit_topo = Topology(
        slice_size=int(own_slice) if own_slice else half,
        region_size=int(own_region) if own_region else None)
    got_link = count_recv_link_bytes(traced, audit_topo)
    want_link = model_link_at(audit_topo)
    for leg, got, want in zip(("ici", "dcn", "wan"), got_link,
                              want_link.tiers):
        tol = max(WIRE_MODEL_RTOL * max(got, want), WIRE_MODEL_ATOL)
        if abs(got - want) > tol:
            return [Finding(
                pass_name="wire_reconciliation", config=traced.name,
                severity="error", stage="grace/exchange",
                message=(
                    f"{type(grace.communicator).__name__}.recv_link_bytes "
                    f"models {leg}={want} B under topology {audit_topo!r} "
                    f"but the traced schedule moves {got} B over that link "
                    f"class (counted split ici={got_link[0]}, "
                    f"dcn={got_link[1]}, wan={got_link[2]}) — drift "
                    f"{abs(got - want)} B exceeds the documented tolerance"
                    f" (rtol={WIRE_MODEL_RTOL}, atol={WIRE_MODEL_ATOL} B)"),
                details=(("leg", leg),
                         ("model_ici", int(want_link.ici)),
                         ("model_dcn", int(want_link.dcn)),
                         ("model_wan", int(want_link.wan)),
                         ("counted_ici", int(got_link[0])),
                         ("counted_dcn", int(got_link[1])),
                         ("counted_wan", int(got_link[2])),
                         ("world", world)))]
    return []


# ---------------------------------------------------------------------------
# pass 4: state signature and host reads inside the step
# ---------------------------------------------------------------------------

def pass_signature_stability(traced: TracedGraph) -> List[Finding]:
    """Two smells of a step that cannot run ahead of the host:

    * the state's signature (every tensor's shape, dtype and device, every
      host field's type) must be a fixed point of the update: a host float
      leaking into ``count``, a residual moving device or dtype, makes
      every later step run on a state the first was not built for;
    * a host read of a value the step computed from its state, gradients
      or batch stalls the host on the card; only the reads that
      :data:`HOST_READ_CONTRACT` names may happen inside a step (the JAX
      package's host-callback check)."""
    findings: List[Finding] = []
    outs = dict(traced.state_out)
    for path, sig_in in traced.state_in:
        sig_out = outs.get(path)
        if sig_out is not None and sig_out != sig_in:
            findings.append(Finding(
                pass_name="signature_stability", config=traced.name,
                severity="error",
                message=(
                    f"state leaf '{path}' is not a signature fixed point: "
                    f"in {sig_in} -> out {sig_out} (a host value of another "
                    "type, or a tensor of another shape, dtype or device, "
                    "leaking into the carried state)"),
                details=(("path", path),)))
    missing = [p for p, _ in traced.state_in if p not in outs]
    if traced.state_out and missing:
        findings.append(Finding(
            pass_name="signature_stability", config=traced.name,
            severity="error",
            message=f"state leaves {missing} vanish in the update",
            details=(("paths", tuple(missing)),)))
    for h in device_reads(traced):
        site = h.attrs["site"]
        if site in HOST_READ_CONTRACT:
            continue
        findings.append(Finding(
            pass_name="signature_stability", config=traced.name,
            severity="error", stage=h.stage,
            message=(
                f"host read '{h.attrs['method']}' at {site} inside the "
                "step of a value it computed — the host waits for the "
                "card every step; keep the value on the device (the "
                "telemetry ring) or read it where the contract allows "
                f"({', '.join(sorted(HOST_READ_CONTRACT))})"),
            details=(("site", site), ("branch", traced.branch))))
    return findings


_PASS_FNS = {
    "collective_consistency": pass_collective_consistency,
    "bit_exactness": pass_bit_exactness,
    "wire_reconciliation": pass_wire_reconciliation,
    "signature_stability": pass_signature_stability,
}


def _resolve_pass(name: str):
    fn = _PASS_FNS.get(name)
    if fn is None:
        from grace_tpu_torch.analysis import flow, state_passes
        _PASS_FNS.update(flow.PASS_FNS)
        _PASS_FNS.update(state_passes.PASS_FNS)
        fn = _PASS_FNS.get(name)
        if fn is None:
            raise ValueError(f"unknown pass {name!r}; the passes are "
                             f"{', '.join(PASS_NAMES)}")
    return fn


def run_passes(traced: TracedGraph,
               passes: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the named passes (default: all ten) over one trace."""
    out: List[Finding] = []
    for name in (passes if passes is not None else PASS_NAMES):
        out.extend(_resolve_pass(name)(traced))
    return out
