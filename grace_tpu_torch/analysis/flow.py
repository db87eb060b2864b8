"""The dependence-graph layer and its three passes; counterpart of the JAX
package's ``analysis/flow.py``.

:func:`build_depgraph` turns a recorded step into one op-level DAG
(ancestor bitsets, gradient-root tracking from the tracer's gradient
values). Three passes ride on it:

* ``overlap_schedulability`` — for every exchange-axis collective, the
  compute that is neither its ancestor nor its descendant is the only work
  a scheduler may run under it: the byte-weighted share is a **static
  upper bound** on the overlap fraction a profile can measure (a measured
  overlap above it means the attribution is wrong). It also counts the
  independent compress→exchange chains: a ``fusion=<bytes>`` plan promises
  K buckets, a ``pipeline=P`` ring P segments, and fewer chains in the
  graph is a serialization point;
* ``numeric_safety`` — value-range interpretation over the payload dtypes:
  a float dtype accumulating more unit-magnitude payload terms than
  ``finfo.max / NUMERIC_UNIT_MAG`` saturates (fp16 at W≈256), vote sums
  against :func:`grace_tpu_torch.comm.vote_exact_max_world`, selection
  index dtypes against the fused leaf sizes, the sub-byte packers against
  their declared widths (:mod:`grace_tpu_torch.ops.packing`), and the
  shared-scale accumulators against ``payload_sum_max_world``;
* ``memory_footprint`` — per-rank GraceState bytes from the traced state
  against the config's own model
  (:func:`grace_tpu_torch.profiling.expected_state_footprint`), the wire
  buffers the collectives write, and replicated state that grows with W.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from grace_tpu_torch.analysis.passes import (Finding, _REDUCTIONS,
                                             _group_size, _on_exchange_axis,
                                             _param_structs)
from grace_tpu_torch.analysis.trace import TracedGraph
from grace_tpu_torch.telemetry.scopes import (STAGE_BUCKET, STAGE_EXCHANGE,
                                              STAGE_PIPELINE)

__all__ = ["DepNode", "DepGraph", "build_depgraph", "overlap_summary",
           "footprint_report", "footprint_model", "safe_sum_terms",
           "NUMERIC_UNIT_MAG", "OVERLAP_SLACK",
           "pass_overlap_schedulability", "pass_numeric_safety",
           "pass_memory_footprint"]

FLOW_PASS_NAMES = ("overlap_schedulability", "numeric_safety",
                   "memory_footprint")

# Slack on the measured-vs-static overlap comparison (the JAX package's).
OVERLAP_SLACK = 0.05

# The per-term magnitude budget of the numeric-safety range analysis: one
# rank's payload element is taken to be at most this many units, so a
# dtype holds finfo.max / 256 such terms (~255 for fp16, ~10^36 for fp32
# and bf16). The JAX package's constant.
NUMERIC_UNIT_MAG = 256.0


def safe_sum_terms(dtype) -> Optional[int]:
    """How many unit-magnitude payload terms a float dtype accumulates
    before it overflows: ``floor(finfo.max / NUMERIC_UNIT_MAG)``; None
    for other dtypes (integer reductions are the sanctioned bit space)."""
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        return None
    return int(float(torch.finfo(dtype).max) / NUMERIC_UNIT_MAG)


_CHAIN_RE = re.compile(r"(?:%s|%s)/(\d+)" % (re.escape(STAGE_BUCKET),
                                            re.escape(STAGE_PIPELINE)))


def _chain_of(scope: str) -> Optional[str]:
    """The chain tags a node ran under: a ``grace/bucket/<b>`` or a
    ``grace/pipeline/<p>`` scope (both joined)."""
    tags = [m.group(0) for m in _CHAIN_RE.finditer(scope)]
    return "|".join(tags) if tags else None


# ---------------------------------------------------------------------------
# the dependence graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DepNode:
    """One recorded op. ``nbytes``: its output bytes (a collective's
    operand bytes where larger: a ``send`` writes nothing), the cost proxy;
    ``roots``: a bitmask over the trace's gradient values it descends
    from; ``chain``: its bucket or pipeline-segment tag."""

    idx: int
    prim: str
    stage: str
    nbytes: int
    collective: bool
    roots: int = 0
    chain: Optional[str] = None
    compute: bool = True     # False: an allocation or a host read


@dataclasses.dataclass
class DepGraph:
    """Op-level dependence DAG of one trace: ``anc[i]`` is the bitmask of
    node ``i``'s transitive ancestors."""

    nodes: List[DepNode]
    anc: List[int]
    n_grad_roots: int

    def is_ancestor(self, a: int, b: int) -> bool:
        """True iff node ``a``'s output (transitively) feeds node ``b``."""
        return bool((self.anc[b] >> a) & 1)


def build_depgraph(traced: TracedGraph) -> DepGraph:
    """The traced step as one DAG (node ``i``: the step's ``i``-th op): a
    node's ancestors are its inputs' producers and theirs; a value's
    gradient roots are its own bit where it is one of ``traced.grad_in``,
    else its producer's."""
    grad_bit = {v: i for i, v in enumerate(traced.grad_in)}
    producer: Dict[int, int] = {}
    val_root: Dict[int, int] = {v: 1 << b for v, b in grad_bit.items()}
    nodes: List[DepNode] = []
    anc: List[int] = []
    for i, node in enumerate(traced.step_nodes):
        a = r = 0
        for v in node.ins:
            p = producer.get(v)
            if p is not None:
                a |= anc[p] | (1 << p)
            r |= val_root.get(v, 0)
        coll = _on_exchange_axis(traced, node)
        nbytes = node.out_nbytes
        if node.kind == "collective":
            nbytes = max(nbytes, node.in_nbytes)
        nodes.append(DepNode(idx=i, prim=node.name, stage=node.stage,
                             nbytes=nbytes, collective=coll, roots=r,
                             chain=_chain_of(node.scope),
                             compute=bool(node.ins)
                             and node.kind in ("op", "kernel")))
        anc.append(a)
        for v in node.outs:
            producer[v] = i
            if v not in grad_bit:
                val_root[v] = r
    return DepGraph(nodes=nodes, anc=anc, n_grad_roots=len(traced.grad_in))


# ---------------------------------------------------------------------------
# pass 5: overlap schedulability
# ---------------------------------------------------------------------------

def overlap_summary(traced: TracedGraph,
                    graph: Optional[DepGraph] = None) -> Dict[str, Any]:
    """The schedulability numbers of one trace (module docstring):
    ``static_overlap_bound``, ``independent_chains`` (exchange-stage
    collectives with no exchange-stage ancestor, grouped by gradient-root
    set and chain tag), ``exchange_collectives``, ``per_collective``."""
    g = graph if graph is not None else build_depgraph(traced)
    computes = [n for n in g.nodes if not n.collective and n.nbytes > 0
                and n.compute]
    colls = [n for n in g.nodes if n.collective]
    total_compute = sum(n.nbytes for n in computes)
    per = []
    for c in colls:
        indep = sum(n.nbytes for n in computes
                    if not g.is_ancestor(c.idx, n.idx)
                    and not g.is_ancestor(n.idx, c.idx))
        cost = max(c.nbytes, 1)
        per.append({"prim": c.prim, "stage": c.stage,
                    "collective_bytes": c.nbytes,
                    "independent_compute_bytes": indep,
                    "bound": min(1.0, indep / cost)})
    weight = sum(max(c.nbytes, 1) for c in colls)
    bound = (sum(max(c.nbytes, 1) * p["bound"]
                 for c, p in zip(colls, per)) / weight if colls else None)
    ex = [c for c in colls if c.stage == STAGE_EXCHANGE]
    heads = [c for c in ex
             if not any(g.is_ancestor(o.idx, c.idx) for o in ex if o is not c)]
    chains = {((n.roots if n.roots else ("head", n.idx)), n.chain)
              for n in heads}
    return {"n_collectives": len(colls),
            "exchange_collectives": len(ex),
            "independent_chains": len(chains),
            "total_compute_bytes": total_compute,
            "static_overlap_bound": bound,
            "per_collective": per}


def _expected_chains(traced: TracedGraph) -> Optional[int]:
    """How many independent compress→exchange chains the config promises:
    ``meta['expected_chains']``, else the ``fusion=<bytes>`` plan's bucket
    count times the ring's pipeline depth (``pipeline > 1`` alone promises
    that many segments); None where the config promises nothing."""
    override = traced.meta.get("expected_chains")
    if override is not None:
        return int(override)
    grace = traced.meta.get("grace")
    if grace is None:
        return None
    pipeline = int(getattr(getattr(grace, "communicator", None),
                           "pipeline", 1) or 1)
    fusion = getattr(grace, "fusion", None)
    if not isinstance(fusion, int) or isinstance(fusion, bool):
        return pipeline if pipeline > 1 else None
    from grace_tpu_torch.transform import _bucketize

    structs = list(_param_structs(traced).values())
    buckets, _ = _bucketize(structs, int(fusion))
    return len(buckets) * pipeline


def pass_overlap_schedulability(traced: TracedGraph) -> List[Finding]:
    """A **serialization point** (the plan promises K chains, the graph
    exposes fewer: one bucket's exchange waits on another's) and a
    **measured overlap above the static bound** (``meta
    ['measured_overlap']`` beyond the bound by more than
    :data:`OVERLAP_SLACK`: the profile misattributes spans)."""
    findings: List[Finding] = []
    s = overlap_summary(traced)
    expected = _expected_chains(traced)
    if (expected is not None and expected > 1
            and s["exchange_collectives"] >= expected
            and s["independent_chains"] < expected):
        findings.append(Finding(
            pass_name="overlap_schedulability", config=traced.name,
            severity="error", stage=STAGE_EXCHANGE,
            message=(
                f"bucketing promises {expected} independent "
                "compress->exchange chains but the traced step exposes "
                f"only {s['independent_chains']} "
                f"({s['exchange_collectives']} exchange collectives, the "
                "rest transitively depend on another bucket's exchange) — "
                "a serialization point: the buckets' wire time issues back "
                "to back instead of overlapping the remaining compute"),
            details=(("expected_chains", int(expected)),
                     ("independent_chains", int(s["independent_chains"])),
                     ("world", traced.world))))
    measured = traced.meta.get("measured_overlap")
    bound = s["static_overlap_bound"]
    if (measured is not None and bound is not None
            and float(measured) > bound + OVERLAP_SLACK):
        findings.append(Finding(
            pass_name="overlap_schedulability", config=traced.name,
            severity="error", stage=STAGE_EXCHANGE,
            message=(
                f"measured overlap fraction {float(measured):.3f} exceeds "
                f"the static upper bound {bound:.3f} (+{OVERLAP_SLACK} "
                "slack) — the dataflow permits at most that much "
                "independent compute under the collectives, so the "
                "measured attribution (grace_tpu_torch.profiling overlap "
                "fraction) is misattributing spans"),
            details=(("measured_overlap", float(measured)),
                     ("static_overlap_bound", round(bound, 6)),
                     ("world", traced.world))))
    return findings


# ---------------------------------------------------------------------------
# pass 6: numeric-range safety
# ---------------------------------------------------------------------------

_ADDS = re.compile(r"^aten\.(add|sub|add_|sub_|_foreach_add|_foreach_add_|"
                   r"_foreach_sub|_foreach_sub_)\.")
_CONTRACTIONS = re.compile(r"^aten\.(mm|bmm|addmm|matmul|mv|dot|"
                           r"convolution|_convolution)\.")


def _multiplicity_walk(traced: TracedGraph):
    """Forward value-range dataflow: each value's accumulated payload-term
    multiplicity. Inputs seed at 1 (one rank's term), values made in the
    step from nothing at 0. Adds sum their inputs' multiplicities, an
    exchange-axis reduction multiplies by the ranks it spans, a sum by the
    extent it reduces, a conversion into a float dtype mints a fresh term,
    contractions and everything else take the max. Returns (the worst
    multiplicity per float dtype with its stage, the vote reductions as
    ``(dtype, stage, span)``)."""
    worst: Dict[str, Tuple[int, str]] = {}
    votes: List[Tuple[torch.dtype, str, int]] = []
    mult: Dict[int, int] = {}
    for seeds in traced.seeds.values():
        for v in seeds:
            mult[v] = 1
    for node in traced.nodes:
        ms = [mult.get(v, 0) for v in node.ins]
        m_in = max(ms, default=0)
        name = node.name
        if node.kind == "collective":
            if name in _REDUCTIONS and _on_exchange_axis(traced, node):
                span = _group_size(traced, node)
                out = max(m_in, 1) * span
                if "psum_vote" in node.scope and node.idx >= traced.start:
                    for _s, d in node.in_meta:
                        votes.append((d, node.stage, span))
            else:
                out = m_in
        elif node.kind == "op" and _ADDS.match(name):
            out = sum(ms)
        elif node.kind == "op" and (name.startswith("aten.sum")
                                    or name.startswith("aten.mean")):
            out = m_in * max(int(node.attrs.get("extent", 1)), 1)
        elif name == "aten._to_copy.default":
            src, dst = node.attrs.get("src"), node.attrs.get("dst")
            out = 1 if (isinstance(dst, torch.dtype) and dst != src
                        and dst.is_floating_point) else m_in
        else:
            out = m_in
        for v in node.outs:
            mult[v] = out
        if node.idx < traced.start:
            continue
        for _s, d in node.out_meta:
            safe = safe_sum_terms(d)
            if safe is not None and out > safe:
                key = str(d).replace("torch.", "")
                if key not in worst or out > worst[key][0]:
                    worst[key] = (out, node.stage)
    return worst, votes


def _rung_compressors(grace) -> List[Any]:
    """Every codec the config can run an exchange with: the base codec, or
    every non-dense rung of the adaptive ladder."""
    adapt = getattr(grace, "adapt", None)
    ladder = tuple(getattr(adapt, "ladder", ()) or ())
    out: List[Any] = []
    for comp in (getattr(grace, "compressor", None),) + ladder:
        if comp is not None and all(comp is not c for c in out):
            out.append(comp)
    return out


def _codec_payload_entries(traced: TracedGraph):
    """``(n_elems, (shape, dtype), compressor)`` per compress call: the
    fusion enumeration (``transform.fusion_payload_structs``) with the
    codec of each call (a route's per leaf, every ladder rung's)."""
    from grace_tpu_torch.transform import fusion_payload_structs

    grace = traced.meta.get("grace")
    named = _param_structs(traced)
    if getattr(grace, "routes", None):
        from grace_tpu_torch.helper import route_leaves
        return [(math.prod(s[0]), s, comp)
                for _p, s, comp, _m, _cm in route_leaves(grace, named)]
    fusion = getattr(grace, "fusion", None)
    return [(math.prod(s[0]), s, comp)
            for comp in _rung_compressors(grace)
            for s, _count in fusion_payload_structs(list(named.values()),
                                                    fusion)]


def _payload_structs(compressor, struct) -> Optional[List[Tuple]]:
    """The ``(shape, dtype)`` of each payload tensor ``compressor`` ships
    for a leaf of ``struct``, from an encode on fake CPU tensors; None
    where the encode cannot run alone (a codec whose compress runs a
    collective)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from grace_tpu_torch.core import LeafKey

    shape, dtype = struct
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = torch.zeros(shape, dtype=dtype)
            payload, _ctx, _ = compressor.compress(
                x, compressor.init_state(x), LeafKey(0, 0, 0))
            return [(tuple(t.shape), t.dtype) for t in payload]
    except Exception:                                    # noqa: BLE001
        return None


_SIGNED_INTS = (torch.int8, torch.int16, torch.int32, torch.int64)


def _index_dtype_findings(traced: TracedGraph) -> List[Finding]:
    """A signed-integer payload smaller than its leaf is an index table;
    its dtype must address ``n_elems - 1`` or the decode scatters wrap."""
    if traced.meta.get("grace") is None:
        return []
    findings: List[Finding] = []
    for n_elems, struct, compressor in _codec_payload_entries(traced):
        for shape, dt in _payload_structs(compressor, struct) or ():
            if dt not in _SIGNED_INTS:
                continue
            size = math.prod(shape)
            if size >= n_elems:
                continue
            top = int(torch.iinfo(dt).max)
            if top < n_elems - 1:
                name = str(dt).replace("torch.", "")
                findings.append(Finding(
                    pass_name="numeric_safety", config=traced.name,
                    severity="error", stage="grace/compress",
                    message=(
                        f"{type(compressor).__name__} ships a {name} index "
                        f"payload ({size} entries) for a {n_elems}-element "
                        f"fused leaf, but iinfo({name}).max = {top} < "
                        f"{n_elems - 1} — positions past the dtype's range "
                        "wrap on decode and scatter into the wrong "
                        "coordinates silently; widen the index dtype or "
                        "shrink the fusion buckets"),
                    details=(("index_dtype", name),
                             ("n_elems", int(n_elems)))))
    return findings


def _packing_findings(traced: TracedGraph, pack_fns=None) -> List[Finding]:
    """When the codec ships a sub-byte packed payload (a uint8 tensor
    smaller than the element count), the packers of
    :mod:`grace_tpu_torch.ops.packing` must round-trip their declared
    widths and pack into ``ceil(n*width/8)`` bytes. ``pack_fns`` injects
    other packers (the seeded tests)."""
    if traced.meta.get("grace") is None:
        return []
    packed = False
    for n_elems, struct, compressor in _codec_payload_entries(traced):
        for shape, dt in _payload_structs(compressor, struct) or ():
            if dt == torch.uint8 and 0 < math.prod(shape) < n_elems:
                packed = True
    if not packed:
        return []
    failures = (_packing_contract(pack_fns) if pack_fns is not None
                else _packing_contract_cached())
    return [Finding(pass_name="numeric_safety", config=traced.name,
                    severity="error", stage="grace/compress", message=msg)
            for msg in failures]


@functools.lru_cache(maxsize=1)
def _packing_contract_cached() -> Tuple[str, ...]:
    return _packing_contract(None)


def _packing_contract(pack_fns) -> Tuple[str, ...]:
    from grace_tpu_torch.ops import packing

    fns = pack_fns or packing.pack_widths()
    out: List[str] = []
    for width, pack, unpack in fns:
        per_byte = 8 // width
        for n in (1, per_byte - 1 or 1, per_byte, per_byte + 1, 64):
            codes = torch.full((n,), (1 << width) - 1, dtype=torch.uint8)
            got_packed = pack(codes)
            want = -(-n * width // 8)
            if got_packed.numel() != want:
                out.append(
                    f"ops/packing: {width}-bit pack of {n} codes produced "
                    f"{got_packed.numel()} bytes, expected "
                    f"ceil({n}*{width}/8) = {want} — the wire-size model "
                    "and every byte count downstream of it are wrong")
                continue
            got = unpack(got_packed, n)
            if not torch.equal(got.to(torch.uint8), codes):
                out.append(
                    f"ops/packing: {width}-bit round-trip of max code "
                    f"{(1 << width) - 1} over {n} lanes does not "
                    "reconstruct — the declared pack width truncates "
                    "in-range codes (silent payload corruption)")
    return tuple(out)


def _shared_scale_findings(traced: TracedGraph) -> List[Finding]:
    """A ``shared_scale`` codec's integer accumulator must cover ``world ·
    max_level`` on the payload-summing schedules: the codec's own
    ``payload_sum_max_world``, the constant the communicators' runtime
    gate raises from."""
    from grace_tpu_torch import comm

    grace = traced.meta.get("grace")
    if grace is None or not isinstance(
            getattr(grace, "communicator", None),
            (comm.Allreduce, comm.RingAllreduce,
             comm.ReduceScatterAllreduce, comm.HierarchicalAllreduce)):
        return []
    findings: List[Finding] = []
    for comp in _rung_compressors(grace):
        if getattr(comp, "payload_algebra", None) != "shared_scale":
            continue
        bound = comp.payload_sum_max_world()
        if bound is None or traced.world <= bound:
            continue
        findings.append(Finding(
            pass_name="numeric_safety", config=traced.name,
            severity="error", stage=STAGE_EXCHANGE,
            message=(
                f"{type(comp).__name__} payload-space sum spans "
                f"world={traced.world} ranks but its integer accumulator "
                f"carries exact sums only up to world {bound} "
                "(payload_sum_max_world, the runtime gate's constant); "
                "beyond it level sums wrap with no NaN/inf for the guard "
                "to catch — widen accum_dtype or lower quantum_num"),
            details=(("payload_sum_max_world", int(bound)),
                     ("world", traced.world))))
    return findings


def pass_numeric_safety(traced: TracedGraph) -> List[Finding]:
    """Value-range safety of the step's payload arithmetic (module
    docstring): float accumulation past ``finfo.max / NUMERIC_UNIT_MAG``
    terms, vote sums past ``comm.vote_exact_max_world``, shared-scale
    accumulators past ``payload_sum_max_world``, index dtypes and packer
    widths."""
    from grace_tpu_torch.comm import vote_exact_max_world

    findings: List[Finding] = []
    worst, votes = _multiplicity_walk(traced)
    for dtype, (mult, stage) in sorted(worst.items()):
        safe = safe_sum_terms(getattr(torch, dtype))
        findings.append(Finding(
            pass_name="numeric_safety", config=traced.name,
            severity="error", stage=stage,
            message=(
                f"{dtype} accumulation reaches {mult} payload terms at "
                f"world={traced.world} but the dtype saturates at "
                f"~{safe} terms of magnitude {NUMERIC_UNIT_MAG:g} "
                f"(finfo({dtype}).max) — the sum overflows to inf with no "
                "NaN for the guard to catch; accumulate in "
                "float32/bfloat16 and downcast the result, or cap the "
                "schedule's span"),
            details=(("dtype", dtype), ("terms", int(mult)),
                     ("safe_terms", int(safe)), ("world", traced.world))))
    seen = set()
    for dtype, stage, span in votes:
        if not dtype.is_floating_point:
            continue
        bound = vote_exact_max_world(dtype)
        name = str(dtype).replace("torch.", "")
        if span > bound and (name, span) not in seen:
            seen.add((name, span))
            findings.append(Finding(
                pass_name="numeric_safety", config=traced.name,
                severity="error", stage=stage,
                message=(
                    f"majority-vote all-reduce in {name} spans {span} ranks "
                    f"but ±1 vote sums are integer-exact only up to {bound} "
                    "(2^(mantissa+1) — comm.vote_exact_max_world, the same "
                    "constant the runtime check enforces); beyond it vote "
                    "tallies round and the election silently flips — use "
                    "vote_dtype='float32'"),
                details=(("vote_dtype", name), ("span", int(span)),
                         ("exact_max_world", int(bound)))))
    findings.extend(_shared_scale_findings(traced))
    findings.extend(_index_dtype_findings(traced))
    findings.extend(_packing_findings(traced))
    return findings


# ---------------------------------------------------------------------------
# pass 7: memory footprint
# ---------------------------------------------------------------------------

def footprint_model(grace, params, world: int = 1) -> Dict[str, int]:
    """The config's expected per-rank GraceState bytes scaled to ``world``:
    :func:`grace_tpu_torch.profiling.expected_state_footprint` itself, so
    the static pass and the runtime recorder never disagree. ``params``
    maps names to tensors or ``(shape, dtype)``."""
    from grace_tpu_torch.profiling.recorder import expected_state_footprint

    import torch.distributed as dist

    from grace_tpu_torch.analysis.trace import fake_world

    structs = {}
    for k, v in params.items():
        shape, dtype = ((tuple(v.shape), v.dtype)
                        if isinstance(v, torch.Tensor) else v)
        structs[k] = torch.empty(tuple(shape), dtype=dtype, device="meta")
    if dist.is_available() and dist.is_initialized():
        return expected_state_footprint(grace, structs, world=world)
    # init asks its communicator's group size: a one-rank fake group
    # answers without peers.
    with fake_world(1):
        return expected_state_footprint(grace, structs, world=world)


def _nbytes(sig) -> int:
    shape, dtype = sig[0], sig[1]
    return math.prod(shape) * getattr(torch, dtype).itemsize


def footprint_report(traced: TracedGraph) -> Dict[str, Any]:
    """Per-rank accounting of one trace: the GraceState tensors grouped as
    ``grace_state_footprint`` groups them (mem / comp / telem+watch /
    bookkeeping), from the traced state's signature, and the wire buffers
    the exchange-axis collectives write (``wire_peak_bytes``: the largest
    single collective output, e.g. an all-gather's (W, k) stack;
    ``wire_total_bytes``: all of them)."""
    mem = comp = telem = book = 0
    for path, sig in traced.state_in:
        if len(sig) < 3:                  # a host field, not a tensor
            continue
        head = path.split("/", 1)[0]
        n = _nbytes(sig)
        if head == "mem":
            mem += n
        elif head == "comp":
            comp += n
        elif head in ("telem", "watch"):
            telem += n
        else:
            book += n
    peak = total = n_coll = 0
    for node in traced.collectives:
        if not _on_exchange_axis(traced, node):
            continue
        n = node.out_nbytes
        peak = max(peak, n)
        total += n
        n_coll += 1
    return {"mem_bytes": mem, "comp_bytes": comp, "telem_bytes": telem,
            "bookkeeping_bytes": book,
            "state_total_bytes": mem + comp + telem + book,
            "wire_peak_bytes": peak, "wire_total_bytes": total,
            "n_collectives": n_coll}


def pass_memory_footprint(traced: TracedGraph) -> List[Finding]:
    """**Replicated O(W) state** (a replicated state tensor with a
    dimension equal to the world size costs O(W) per rank on every rank)
    and a **state-model mismatch** (the traced state's mem/comp/telem
    bytes against the config's own ``init`` model: the trace ran under
    another codec, fusion or telemetry setting)."""
    findings: List[Finding] = []
    for path, (shape, _dtype) in traced.state_replicated:
        if traced.world >= 4 and any(d == traced.world for d in shape):
            findings.append(Finding(
                pass_name="memory_footprint", config=traced.name,
                severity="error",
                message=(
                    f"replicated state leaf '{path}' has shape "
                    f"{tuple(shape)} with a dimension equal to the world "
                    f"size ({traced.world}) — a replicated buffer that "
                    "scales with W costs O(W) memory per rank on EVERY rank "
                    "(O(W²) fleet-wide) and grows each time the job scales; "
                    "keep it per rank or reduce it to a windowed summary"),
                details=(("path", path), ("shape", tuple(map(int, shape))),
                         ("world", traced.world))))
    grace = traced.meta.get("grace")
    model = traced.meta.get("footprint_model")
    if model is None and grace is not None and traced.state_in \
            and hasattr(grace, "transform"):
        try:
            model = footprint_model(grace, _param_structs(traced))
        except (AttributeError, TypeError):
            model = None             # not a Grace bundle: no model
    if model is None or not traced.state_in:
        return findings
    rep = footprint_report(traced)
    for key in ("mem_bytes", "comp_bytes", "telem_bytes"):
        if rep[key] != model[key]:
            findings.append(Finding(
                pass_name="memory_footprint", config=traced.name,
                severity="error",
                message=(
                    f"traced state carries {rep[key]} B of "
                    f"{key.split('_')[0]} state but the config's own init "
                    f"model says {model[key]} B — the trace ran under a "
                    "different codec/fusion/telemetry config than the one "
                    "being audited (the static twin of the recorder's "
                    "grace_state_footprint check)"),
                details=(("component", key),
                         ("traced_bytes", int(rep[key])),
                         ("model_bytes", int(model[key])))))
            break
    return findings


PASS_FNS = {
    "overlap_schedulability": pass_overlap_schedulability,
    "numeric_safety": pass_numeric_safety,
    "memory_footprint": pass_memory_footprint,
}
