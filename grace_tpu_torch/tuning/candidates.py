"""Candidate enumeration: the audited registry plus the tuner's generated
variants; counterpart of the JAX package's ``tuning/candidates.py``, with
its candidates under their names.

* **registry candidates** come from the static auditor's
  ``AUDIT_CONFIGS`` (update mode only; entries with an escape, telemetry,
  a watch or the consensus audit are left out: those are orthogonal to
  the choice and make "the" wire cost bimodal, and so is ``identity``,
  whose zero bytes would win every ranking while exchanging nothing);
* **generated variants** cross the winning families with the knobs a
  target makes relevant: hier at the target's node width, the bucketed
  executor's ``fusion=1024``, the packed qsgd4 wire and its kernel twin.

``Candidate.needs_kernel`` is the JAX package's ``tpu_only``: the
``use_pallas=True`` candidates, which in the port run a hand-written CUDA
kernel. A measurement on the CPU skips them with that reason (their
wrappers would run the plain versions there); on the card they are
measured like the others.

Legality is decided by the gates the communicators raise at build and
step time (a summable payload, the vote, statelessness, a data-free ctx,
whole slices), restated as a cheap static predicate, so an illegal combo
is a funnel record with the runtime's own rationale instead of a
``TypeError`` mid-measurement.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from grace_tpu_torch.tuning.cost import TuneTopology

__all__ = ["Candidate", "registry_candidates", "generated_variants",
           "enumerate_candidates", "candidate_legal",
           "variant_audit_entries"]


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One (codec, communicator, fusion, kernel, precision) combination.
    ``needs_kernel``: the JAX package's ``tpu_only`` (module docstring)."""

    name: str
    params: Dict[str, Any]
    source: str = "registry"        # "registry" | "generated"
    needs_kernel: bool = False

    def build(self, group=None):
        from grace_tpu_torch.helper import grace_from_params
        return grace_from_params(dict(self.params), group=group)


# Params keys of resilience and observability machinery: entries that
# carry them are not selection candidates.
_NON_SELECTION_KEYS = ("escape", "telemetry", "watch", "consensus")


def registry_candidates() -> List[Candidate]:
    from grace_tpu_torch.analysis.configs import AUDIT_CONFIGS

    out = []
    for e in AUDIT_CONFIGS:
        if e.get("mode", "update") != "update":
            continue
        p = dict(e["params"])
        if any(k in p for k in _NON_SELECTION_KEYS) \
                or p.get("communicator") in ("identity", "none"):
            continue
        out.append(Candidate(name=e["name"], params=p, source="registry",
                             needs_kernel=p.get("use_pallas") is True))
    return out


def generated_variants(spec: TuneTopology) -> List[Candidate]:
    """Deterministic topology-aware variants beyond the registry: hier at
    the target's node width (the registry pins slice_size=4 for the 8-way
    audit world), the bucketed executor over the small-world winners, the
    packed qsgd4 wire and its kernel twin, the pipelined ring, the
    homomorphic family and its adaptive ladder, the reduce-scatter."""
    topk = {"compressor": "topk", "compress_ratio": 0.01,
            "topk_algorithm": "chunk", "memory": "residual"}
    qsgd4 = {"compressor": "qsgd", "quantum_num": 7, "use_pallas": False,
             "memory": "none"}
    # Shared-scale homomorphic qsgd4: no requant at any world, so it
    # passes the degradation gate where the flat qsgd ring does not.
    homoq = {"compressor": "homoqsgd", "quantum_num": 7,
             "memory": "residual"}
    out = [
        Candidate("tune-topk1pct-allgather-bucketed",
                  {**topk, "communicator": "allgather", "fusion": 1024},
                  source="generated"),
        Candidate("tune-topk1pct-ring-bucketed",
                  {**topk, "communicator": "ring", "fusion": 1024},
                  source="generated"),
        Candidate("tune-qsgd4-ring-packed-bucketed",
                  {**qsgd4, "communicator": "ring", "fusion": 1024},
                  source="generated"),
        Candidate("tune-qsgd4-ring-packed-bucketed-pallas",
                  {**qsgd4, "use_pallas": True, "communicator": "ring",
                   "fusion": 1024},
                  source="generated", needs_kernel=True),
        Candidate("tune-homoqsgd4-ring",
                  {**homoq, "communicator": "ring", "fusion": "flat"},
                  source="generated"),
        # The double-buffered ring: priced with its declared overlap,
        # refereed by flow pass 5's >= P independent chains.
        Candidate("tune-qsgd4-ring-packed-pipelined",
                  {**qsgd4, "communicator": "ring", "fusion": "flat",
                   "pipeline": 2},
                  source="generated"),
        # The adaptive ladder (dense escape -> homoqsgd8 -> homoqsgd4) over
        # the zero-requant ring, priced at its steady state, every rung's
        # price in the record; the lint-registered adapt-homoqsgd-ring's
        # ladder.
        Candidate("tune-adapt-homoqsgd4-ring",
                  {**homoq, "communicator": "ring", "fusion": "flat",
                   "escape": "fp16", "telemetry": 16,
                   "adapt": {"window": 25,
                             "ladder": [{"quantum_num": 127}]}},
                  source="generated"),
        # The reduce-scatter: one all-to-all and one all-gather, a requant
        # chain of at most 1 at any world.
        Candidate("tune-topk1pct-rscatter",
                  {**topk, "communicator": "rscatter", "fusion": "flat"},
                  source="generated"),
        Candidate("tune-homoqsgd4-rscatter",
                  {**homoq, "communicator": "rscatter", "fusion": "flat"},
                  source="generated"),
    ]
    if spec.fsdp is not None and spec.fsdp > 1:
        # A sharded-model target: Top-K through the per-shard reduce-
        # scatter, LayerNorm and bias leaves dense fp16.
        out.append(Candidate(
            "tune-routed-rscatter-fsdp",
            {**topk, "communicator": "rscatter", "fsdp_axis": "fsdp",
             "route": [("*ln*", {"compressor": "fp16", "memory": "none",
                                 "communicator": "allreduce"}),
                       ("*bias*", {"compressor": "fp16", "memory": "none",
                                   "communicator": "allreduce"})]},
            source="generated"))
    s = spec.slice_size
    if s is not None and spec.world > s:
        out += [
            Candidate(f"tune-topk1pct-hier{s}",
                      {**topk, "communicator": "hier", "slice_size": s,
                       "fusion": "flat"}, source="generated"),
            Candidate(f"tune-topk1pct-hier{s}-bucketed",
                      {**topk, "communicator": "hier", "slice_size": s,
                       "fusion": 1024}, source="generated"),
            Candidate(f"tune-qsgd4-hier{s}-packed",
                      {**qsgd4, "communicator": "hier", "slice_size": s,
                       "fusion": "flat"}, source="generated"),
            Candidate(f"tune-homoqsgd4-hier{s}",
                      {**homoq, "communicator": "hier", "slice_size": s,
                       "fusion": "flat"}, source="generated"),
        ]
    rz = spec.region_size
    if s is not None and rz is not None and spec.world > rz:
        # Three tiers at the target's own widths: Top-K with the deeper
        # WAN re-encode (one boundary requant), and the homomorphic codec,
        # exactly summable across the WAN.
        out += [
            Candidate(f"tune-topk1pct-hier{s}r{rz}",
                      {**topk, "communicator": "hier", "slice_size": s,
                       "region_size": rz, "fusion": "flat",
                       "wan_compressor": {"compressor": "topk",
                                          "compress_ratio": 0.001,
                                          "topk_algorithm": "chunk"}},
                      source="generated"),
            Candidate(f"tune-homoqsgd4-hier{s}r{rz}",
                      {**homoq, "communicator": "hier", "slice_size": s,
                       "region_size": rz, "fusion": "flat"},
                      source="generated"),
        ]
    return out


def enumerate_candidates(spec: TuneTopology) -> List[Candidate]:
    """Registry + generated, by name (a generated variant named like a
    registry entry is that entry)."""
    cands = registry_candidates()
    seen = {c.name for c in cands}
    for c in generated_variants(spec):
        if c.name not in seen:
            cands.append(c)
            seen.add(c.name)
    return cands


def _probe_compress(compressor):
    """``(payload, ctx)`` of ``compressor`` on 64 zeros on the CPU (the
    plain versions), the key a constant one."""
    import torch

    from grace_tpu_torch.core import LeafKey

    x = torch.zeros(64, dtype=torch.float32)
    payload, ctx, _ = compressor.compress(x, None, LeafKey(0, 0, 0))
    return payload, ctx


def _compressor_stateful(compressor) -> bool:
    """Whether the codec carries per-leaf state across steps (Signum's
    momentum, PowerSGD's Q): the shard-parallel communicators reject it."""
    import torch
    try:
        return compressor.init_state(torch.zeros(8)) is not None
    except Exception:                                    # noqa: BLE001
        return True          # a collective in init, or the like


def _ctx_data_free(compressor) -> bool:
    """The shard gate of :func:`grace_tpu_torch.comm._shard_compress`:
    ranks decode each other's shard payloads with their own ctx, which is
    sound only when ctx holds no tensor."""
    from grace_tpu_torch.comm import _holds_tensor
    try:
        _payload, ctx = _probe_compress(compressor)
    except Exception:                                    # noqa: BLE001
        return False
    return not _holds_tensor(ctx)


def _triad_legal(comp, cm, spec: TuneTopology) -> Optional[str]:
    """The static mirror of the communicators' build and step gates for
    one (compressor, communicator) pair at the target world: the reason
    the runtime would raise, or None."""
    from grace_tpu_torch import comm

    w = spec.world
    vote = bool(getattr(comp, "vote_aggregate", False))
    summable = bool(getattr(comp, "summable_payload", False))
    requant = bool(getattr(comp, "supports_hop_requant", False))
    shard_parallel = (comm.TwoShotAllreduce, comm.RingAllreduce,
                      comm.ReduceScatterAllreduce,
                      comm.HierarchicalAllreduce)
    if isinstance(cm, comm.SignAllreduce) and not vote:
        return ("SignAllreduce requires vote_aggregate=True "
                f"({type(comp).__name__} declares False) — the re-sign "
                "would drop its aggregate's scaling")
    if type(cm) is comm.Allreduce and not (vote or summable):
        return ("Allreduce requires summable_payload=True "
                f"({type(comp).__name__} declares False) — per-rank "
                "payloads decode differently")
    if isinstance(cm, shard_parallel):
        if _compressor_stateful(comp):
            return (f"{type(cm).__name__} requires a stateless compressor; "
                    f"{type(comp).__name__} carries cross-step state with "
                    "no per-chunk meaning")
        # The shared scale's hoisted negotiation replaces the ctx gate.
        if getattr(comp, "payload_algebra", None) != "shared_scale" \
                and not _ctx_data_free(comp):
            return (f"{type(cm).__name__} requires a data-free ctx; "
                    f"{type(comp).__name__}.compress puts data-derived "
                    "arrays in ctx — other ranks' shards would decode "
                    "against the wrong values")
    if isinstance(cm, (comm.RingAllreduce, comm.ReduceScatterAllreduce,
                       comm.HierarchicalAllreduce)) \
            and not (summable or requant):
        return (f"{type(cm).__name__} keeps the payload compressed on "
                "every hop, which needs a payload algebra (exact/"
                "shared_scale/sketch — summable_payload) or "
                f"supports_hop_requant; {type(comp).__name__} declares "
                "neither")
    if isinstance(cm, comm.HierarchicalAllreduce):
        s = cm.slice_size
        if s is not None and w > s and w % s:
            return (f"HierarchicalAllreduce(slice_size={s}) does not "
                    f"divide world {w} — the two-level schedule needs "
                    "whole slices")
    return None


def candidate_legal(candidate: Candidate, spec: TuneTopology
                    ) -> Tuple[bool, Optional[str], Any]:
    """``(legal, reason, grace)``: the static mirror of the
    communicators' gates at the target world. ``grace`` is the built
    bundle when it builds (legal or not), else None. A routed candidate's
    every route triad is checked too, and an adaptive one's every rung."""
    try:
        grace = candidate.build()
    except (TypeError, ValueError) as e:
        return False, f"does not build: {type(e).__name__}: {e}", None
    if getattr(grace, "routes", None) and grace.fusion is not None:
        return False, ("routes=... requires fusion=None: per-leaf codec "
                       "routing is per-leaf semantics (grace_transform "
                       "raises the same gate at build time)"), grace
    reason = _triad_legal(grace.compressor, grace.communicator, spec)
    if reason:
        return False, reason, grace
    for pat, comp, _mem, cm in (getattr(grace, "routes", None) or ()):
        reason = _triad_legal(comp, cm, spec)
        if reason:
            return False, f"route {pat!r}: {reason}", grace
    adapt = getattr(grace, "adapt", None)
    for ri, comp in enumerate(getattr(adapt, "ladder", ()) or ()):
        reason = _triad_legal(comp, grace.communicator, spec)
        if reason:
            return False, f"adapt rung {ri + 1}: {reason}", grace
    return True, None, grace


def variant_audit_entries() -> List[Tuple[str, Dict[str, Any], str]]:
    """The tuner's variants pinned into the auditor's registry
    (``analysis.configs.AUDIT_CONFIGS`` holds them), so that ``python -m
    grace_tpu_torch.analysis --all-configs`` covers what the tuner can
    emit: ``(name, params, comment)``. slice_size=4 puts a boundary inside
    the 8-way audit world."""
    topk = {"compressor": "topk", "compress_ratio": 0.01,
            "topk_algorithm": "chunk", "memory": "residual",
            "communicator": "hier", "slice_size": 4}
    return [
        ("tune-topk1pct-hier-bucketed", {**topk, "fusion": 1024},
         "bucketed executor x two-level hier schedule"),
        ("tune-qsgd4-hier-packed",
         {"compressor": "qsgd", "quantum_num": 7, "use_pallas": False,
          "memory": "none", "communicator": "hier", "slice_size": 4,
          "fusion": "flat"},
         "packed 4-bit wire over hier hop+boundary requant"),
        ("tune-qsgd4-ring-packed-pipelined",
         {"compressor": "qsgd", "quantum_num": 7, "use_pallas": False,
          "memory": "none", "communicator": "ring", "fusion": "flat",
          "pipeline": 2},
         "double-buffered packed ring; pass-5 pipelined-chain referee"),
        ("tune-homoqsgd4-rscatter",
         {"compressor": "homoqsgd", "quantum_num": 7, "memory": "residual",
          "communicator": "rscatter", "fusion": "flat"},
         "homomorphic payload-space sum over the rscatter schedule"),
        ("tune-topk1pct-hier3-wan",
         {"compressor": "topk", "compress_ratio": 0.25,
          "topk_algorithm": "chunk", "memory": "residual",
          "communicator": "hier", "slice_size": 2, "region_size": 4,
          "fusion": "flat",
          "wan_compressor": {"compressor": "topk", "compress_ratio": 0.05,
                             "topk_algorithm": "chunk"}},
         "aggressive WAN re-compression over the three-level hier schedule"),
    ]
