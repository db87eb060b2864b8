"""Static pruning: capability gate → numeric gate → degradation gate →
wire price → flow audit; counterpart of the JAX package's
``tuning/prune.py``, with its stages, constants and record.

Every candidate leaves with a funnel record (the stage it died at and
why, or its full static price), in cost order, cheapest first:

1. **capability** — the communicators' own gates, evaluated statically
   (:func:`..candidates.candidate_legal`);
2. **numeric** — payload-space sums and the vote's exactness at the
   target world, from the constants the numeric-safety pass and the
   runtime share (``flow.safe_sum_terms``, ``comm.vote_exact_max_world``,
   the codec's ``payload_sum_max_world``);
3. **degradation** — the cascaded-requant chain at the target world
   (:data:`MAX_REQUANT_CHAIN`): a flat hop-requant ring re-encodes W−1
   times, the ScaleCom-documented reason the winner depends on scale;
4. **price** — the wire-dominated projection (:mod:`..cost`) under the
   target topology; the survivors are ranked;
5. **flow** — the head of the ranking is traced at ``audit_world`` ranks
   (:func:`grace_tpu_torch.analysis.trace.trace_update`, on the card's
   route: fake tensors, no card) and run through flow passes 5–7; an
   error rejects, and the static overlap bound rides into the record as
   the reference the measured overlap is held to. The tracer owns a fake
   default process group: the stage refuses to run beside another one.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist

from grace_tpu_torch.tuning.candidates import Candidate, candidate_legal
from grace_tpu_torch.tuning.cost import TuneTopology, price_candidate

__all__ = ["FLOW_AUDIT_MARGIN", "MAX_REQUANT_CHAIN", "degradation_verdict",
           "numeric_verdict", "requant_chain_length", "static_prune"]

# Ranked survivors flow-audited beyond the shortlist, so that a flow
# rejection still leaves a full shortlist.
FLOW_AUDIT_MARGIN = 2

# The longest tolerated cascaded-requant chain (decompress → accumulate →
# re-encode repetitions on the way to aggregation). The per-hop error is
# about linear in the chain and error feedback covers only the first
# encode; 32 admits every intra-node schedule (S ≤ 32 hops, hier's
# boundary adding one) and rejects flat hop-requant rings at pod scale.
MAX_REQUANT_CHAIN = 32


def _payload_float_dtypes(compressor) -> List[Any]:
    """The float dtypes of the codec's wire payload, from an encode of 64
    zeros on the CPU; codecs whose compress runs a collective (PowerSGD)
    are taken as float32, which holds ~10^36 unit terms."""
    import torch

    from grace_tpu_torch.tuning.candidates import _probe_compress
    try:
        payload, _ctx = _probe_compress(compressor)
    except Exception:                                    # noqa: BLE001
        return [torch.float32]
    from grace_tpu_torch.data import _leaves
    return [t.dtype for t in _leaves(payload)
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def numeric_verdict(grace, spec: TuneTopology) -> Optional[str]:
    """Why the candidate is numerically unsafe at the target world, or
    None: the static twin of flow pass 6 for the two accumulations that
    grow with the world — a payload-space sum of W unit terms in the
    payload dtype (or in the shared scale's integer accumulator), and the
    ±1 vote's all-reduce, exact to ``comm.vote_exact_max_world``. Requant
    paths accumulate decoded partials in float32 and are exempt. Every
    rung of an adaptive ladder is checked: the controller can pick any."""
    from grace_tpu_torch import comm
    from grace_tpu_torch.analysis import flow

    cm = grace.communicator
    w = spec.world
    adapt = getattr(grace, "adapt", None)
    rungs = list(getattr(adapt, "ladder", ()) or ())
    comps = [grace.compressor] + [c for c in rungs if c != grace.compressor]
    for ri, comp in enumerate(comps):
        where = "" if ri == 0 else "adapt rung: "
        vote = bool(getattr(comp, "vote_aggregate", False))
        if vote and isinstance(cm, (comm.Allreduce, comm.SignAllreduce)):
            vd = getattr(cm, "vote_dtype", "bfloat16")
            bound = comm.vote_exact_max_world(vd)
            if w > bound:
                return (f"{where}±1 vote psum in {vd} is integer-exact "
                        f"only to W={bound} (vote_exact_max_world); W={w} "
                        "ties would silently round — the runtime vote "
                        "guard raises here")
        summable = bool(getattr(comp, "summable_payload", False))
        if not (summable and not vote and isinstance(
                cm, (comm.Allreduce, comm.RingAllreduce,
                     comm.ReduceScatterAllreduce,
                     comm.HierarchicalAllreduce))):
            continue
        if getattr(comp, "payload_algebra", None) == "shared_scale":
            bound = comp.payload_sum_max_world()
            if bound is not None and w > bound:
                return (f"{where}shared-scale payload sum of W={w} integer "
                        f"levels exceeds payload_sum_max_world={bound} "
                        "(iinfo(accum_dtype).max // max level) — level "
                        "sums wrap silently; widen accum_dtype or lower "
                        "quantum_num (the communicators raise the same "
                        "bound on a live group)")
        for dt in _payload_float_dtypes(comp):
            terms = flow.safe_sum_terms(dt)
            if terms is not None and w > terms:
                return (f"{where}payload-space sum of W={w} "
                        f"{str(dt).replace('torch.', '')} terms exceeds "
                        f"safe_sum_terms({str(dt).replace('torch.', '')})"
                        f"={terms} (finfo.max/{int(flow.NUMERIC_UNIT_MAG)} "
                        "unit magnitudes) — silent inf, the flow pass-6 "
                        "cliff")
    return None


def requant_chain_length(grace, spec: TuneTopology) -> int:
    """How many times the candidate re-encodes a partial sum on its way to
    aggregation at the target world: 0 for payload-exact, gather and vote
    schedules; W−1 for a flat hop-requant ring; S−1 intra-node hops plus
    one boundary re-encode for hier (one, whatever K); 1 for two-shot's
    second encode and for the reduce-scatter's one re-encode."""
    from grace_tpu_torch import comm

    comp, cm = grace.compressor, grace.communicator
    summable = bool(getattr(comp, "summable_payload", False))
    requant = bool(getattr(comp, "supports_hop_requant", False))
    w = spec.world
    if summable or not requant:
        return 1 if isinstance(cm, comm.TwoShotAllreduce) and not summable \
            else 0
    if isinstance(cm, comm.ReduceScatterAllreduce):
        return 1
    if isinstance(cm, comm.HierarchicalAllreduce):
        s = cm.slice_size
        if s is None or w <= s:
            return max(0, w - 1)            # collapses to the flat ring
        return (s - 1) + 1
    if isinstance(cm, comm.RingAllreduce):
        return max(0, w - 1)
    if isinstance(cm, comm.TwoShotAllreduce):
        return 1
    return 0


def degradation_verdict(grace, spec: TuneTopology) -> Optional[str]:
    """Why the candidate's compression degrades at the target scale, or
    None: the ScaleCom gate (:data:`MAX_REQUANT_CHAIN`)."""
    chain = requant_chain_length(grace, spec)
    if chain > MAX_REQUANT_CHAIN:
        return (f"cascaded requant chain of {chain} re-encodes at W="
                f"{spec.world} exceeds MAX_REQUANT_CHAIN="
                f"{MAX_REQUANT_CHAIN}: per-hop requant error is ~linear in "
                "chain length and uncovered by error feedback past stage 1 "
                "— the topk-family large-W degradation ScaleCom documents; "
                "use a hierarchical or two-shot schedule there")
    return None


def _flow_audit(candidate: Candidate, audit_world: int):
    """``(record, traced)``: one survivor traced at ``audit_world`` ranks
    and run through flow passes 5–7; the record holds
    ``overlap_bound``, ``independent_chains`` and ``errors`` (which
    reject)."""
    from grace_tpu_torch.analysis.flow import (overlap_summary,
                                               pass_memory_footprint,
                                               pass_numeric_safety,
                                               pass_overlap_schedulability)
    from grace_tpu_torch.analysis.trace import trace_update

    # The params dict: a 2-D candidate binds the fake world's mesh.
    traced = trace_update(dict(candidate.params), world=audit_world,
                          name=candidate.name)
    findings = (pass_overlap_schedulability(traced)
                + pass_numeric_safety(traced)
                + pass_memory_footprint(traced))
    s = overlap_summary(traced)
    bound = s["static_overlap_bound"]
    return {"overlap_bound": (round(bound, 6) if bound is not None
                              else None),
            "independent_chains": int(s["independent_chains"]),
            "errors": [f"{f.pass_name}: {f.message}" for f in findings
                       if f.severity == "error"]}, traced


def static_prune(candidates: List[Candidate], spec: TuneTopology,
                 model_structs, *, audit_world: int = 8,
                 shortlist_n: int = 3,
                 constants: Optional[Tuple[float, float, float]] = None,
                 include: Sequence[str] = (),
                 traces: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """The whole static funnel for one target topology (the JAX package's
    document): ``{"topology", "funnel", "ranking", "shortlist",
    "counts"}``. ``funnel`` holds one record a candidate in enumeration
    order, ``ranking`` the priced survivors by projected step time,
    ``shortlist`` the top ``shortlist_n`` that pass the flow audit, then
    the ``include``\\ d names that reach the price stage and pass it too
    (each flow-audited). ``constants`` prices with other bandwidths
    (:func:`..cost.projection_constants`); ``traces`` collects each
    flow-audited candidate's trace by name (the measured stage re-runs
    the overlap pass on it)."""
    funnel: List[Dict[str, Any]] = []
    by_name: Dict[str, Dict[str, Any]] = {}
    cands: Dict[str, Candidate] = {}
    for c in candidates:
        rec: Dict[str, Any] = {"candidate": c.name, "source": c.source,
                               "params": dict(c.params)}
        if c.needs_kernel:
            rec["needs_kernel"] = True
        funnel.append(rec)
        by_name[c.name] = rec
        cands[c.name] = c
        legal, reason, grace = candidate_legal(c, spec)
        if not legal:
            rec.update(stage="capability", verdict="rejected",
                       reason=reason)
            continue
        reason = numeric_verdict(grace, spec)
        if reason:
            rec.update(stage="numeric", verdict="rejected", reason=reason)
            continue
        # Every survivor's chain rides its record: 0 is the homomorphic
        # claim, W−1 the flat hop-requant ring the next gate stops.
        rec["requant_chain"] = requant_chain_length(grace, spec)
        reason = degradation_verdict(grace, spec)
        if reason:
            rec.update(stage="degradation", verdict="rejected",
                       reason=reason)
            continue
        try:
            price = price_candidate(grace, model_structs, spec,
                                    constants=constants)
        except Exception as e:                           # noqa: BLE001
            rec.update(stage="price", verdict="rejected",
                       reason=f"unpriceable: {type(e).__name__}: {e}")
            continue
        rec.update(stage="price", verdict="priced", predicted=price)

    def audit(r) -> bool:
        name = r["candidate"]
        try:
            record, traced = _flow_audit(cands[name], audit_world)
        except Exception as e:                           # noqa: BLE001
            if dist.is_available() and dist.is_initialized():
                raise       # the tracer's refusal: no bound without it
            record, traced = None, e
        if record is None:
            r.update(stage="flow", verdict="rejected",
                     reason=f"failed to trace on the audit world: "
                            f"{type(traced).__name__}: {traced}")
            return False
        if traces is not None:
            traces[name] = traced
        r["flow"] = {k: v for k, v in record.items() if k != "errors"}
        r["flow"]["audit_world"] = audit_world
        if record["errors"]:
            r.update(stage="flow", verdict="rejected",
                     reason="; ".join(record["errors"]))
            return False
        r.update(stage="flow", verdict="shortlisted")
        return True

    ranked = sorted(
        (r for r in funnel if r.get("verdict") == "priced"),
        key=lambda r: (r["predicted"]["projected_step_ms"], r["candidate"]))
    audit_n = shortlist_n + FLOW_AUDIT_MARGIN
    shortlist: List[str] = []
    for r in ranked:
        if len(shortlist) >= shortlist_n or audit_n <= 0:
            break
        audit_n -= 1
        if audit(r):
            shortlist.append(r["candidate"])
    for name in include:
        r = by_name.get(name)
        if r is None:
            raise ValueError(f"include names {name!r}, which is not a "
                             "candidate of this topology")
        if r.get("verdict") == "priced" and audit(r):
            shortlist.append(name)
    return {
        "topology": {"world": spec.world, "slice_size": spec.slice_size,
                     "region_size": spec.region_size,
                     "label": spec.label},
        "funnel": funnel,
        "ranking": [{"candidate": r["candidate"],
                     "projected_step_ms":
                         r["predicted"]["projected_step_ms"],
                     "predicted_speedup_vs_dense":
                         r["predicted"]["predicted_speedup_vs_dense"],
                     "ici_bytes": r["predicted"]["ici_bytes"],
                     "dcn_bytes": r["predicted"]["dcn_bytes"],
                     "wan_bytes": r["predicted"]["wan_bytes"],
                     "verdict": r["verdict"]}
                    for r in ranked],
        "shortlist": shortlist,
        "counts": {
            "enumerated": len(funnel),
            "capability_rejected": sum(
                1 for r in funnel if r.get("stage") == "capability"),
            "numeric_rejected": sum(
                1 for r in funnel if r.get("stage") == "numeric"),
            "degradation_rejected": sum(
                1 for r in funnel if r.get("stage") == "degradation"),
            "priced": len(ranked),
            "flow_rejected": sum(
                1 for r in funnel if r.get("stage") == "flow"
                and r.get("verdict") == "rejected"),
            "shortlisted": len(shortlist),
        },
    }
