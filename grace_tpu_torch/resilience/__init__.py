"""Training resilience: the non-finite step guard, the dense escape, the
cross-rank consistency audit, the fault injectors, the adaptive
compression ladder and elastic resize; counterpart of the JAX package's
``resilience`` (its ``guard``, ``guarded_chain``, ``consensus``,
``chaos``, ``adapt``, ``elastic`` and ``retune``).

* :func:`guard_transform` wraps the GRACE transform and the torch
  optimizer: a step whose update or new state is non-finite (or whose
  update norm exceeds ``max_norm``) is skipped, and the parameters, the
  optimizer state and every GraceState tensor roll back together.
* The dense escape: ``grace_transform(escape=...)`` with the guard's
  ``fallback_after``/``fallback_steps``: after K consecutive bad steps the
  exchange is a dense (none/fp16/bf16) all-reduce for M steps, then
  compression re-arms.
* :func:`consensus_step` (``train.make_train_step(consensus=...)``)
  fingerprints the replicated state every ``audit_every`` steps, compares
  the fingerprints across ranks, and repairs a divergent rank: the
  majority's state broadcast bit for bit, the divergent rank's residuals
  zeroed, the dense escape armed when the same rank diverges again
  (:func:`audit_report`, ``utils.logging.ConsensusMonitor``).
* :class:`ChaosCompressor`, :class:`ChaosCommunicator` and
  :class:`ChaosParams` inject seeded faults: NaN/Inf implants, payload bit
  flips, stale residuals, encoder drift, and one flipped bit in one rank's
  copy of the parameters.
* The adaptive ladder (``grace_transform(adapt=...)``,
  ``grace_from_params({"adapt": ...})``): each update runs one rung of a
  ladder from the dense escape up to the config's codec, and a controller
  tightens on error spikes or guard evidence and loosens with hysteresis
  (:class:`AdaptConfig`, :func:`adapt_report`, :class:`AdaptMonitor`).
* Elastic resize: :func:`plan_resize`, :func:`resize_group` and
  :func:`reshard_grace_state` carry the replicated state onto a group of
  survivors and re-initialize the per-rank state;
  :func:`rejoin_barrier` repairs a rejoining rank with one forced audit;
  :class:`ElasticController` drains on watch anomalies.
* Online re-tuning (:class:`RetuneController`): sustained compression-error
  drift arms a promotion to another configuration, staged (lint audit,
  state migration, footprint check, last-known-good checkpoint) without
  writing the live state, committed behind the consensus barrier, and
  demoted bit for bit (:func:`state_digest`) when the guard trips during
  its probation.
"""

from __future__ import annotations

from typing import Optional

from grace_tpu_torch.resilience.adapt import (AdaptConfig, AdaptMonitor,
                                              AdaptState, adapt_report,
                                              normalize_adapt)
from grace_tpu_torch.resilience.chaos import (ChaosCommunicator,
                                              ChaosCompressor, ChaosParams)
from grace_tpu_torch.resilience.consensus import (ConsensusConfig,
                                                  audit_report,
                                                  consensus_step,
                                                  fingerprint_tree,
                                                  force_audit,
                                                  normalize_consensus,
                                                  replicated_view)
from grace_tpu_torch.resilience.elastic import (ElasticController,
                                                ResizePlan,
                                                barrier_wire_bytes,
                                                implant_stale_replica,
                                                plan_resize, rejoin_barrier,
                                                replica_variants,
                                                reshard_grace_state,
                                                resize_group,
                                                validate_resharded)
from grace_tpu_torch.resilience.retune import (RetuneController,
                                               StagedPromotion, state_digest)
from grace_tpu_torch.resilience.guard import (GUARD_ROLLBACK_EXCLUDED,
                                              GUARD_SCAN_EXCLUDED_TYPES,
                                              GuardState, GuardTransform,
                                              guard_transform)

__all__ = ["GUARD_ROLLBACK_EXCLUDED", "GUARD_SCAN_EXCLUDED_TYPES",
           "GuardState", "GuardTransform", "guard_transform",
           "guarded_chain", "ConsensusConfig", "normalize_consensus",
           "replicated_view", "fingerprint_tree", "consensus_step",
           "force_audit", "audit_report", "ChaosCompressor",
           "ChaosCommunicator", "ChaosParams", "AdaptConfig", "AdaptState",
           "AdaptMonitor", "adapt_report", "normalize_adapt", "ResizePlan",
           "plan_resize", "resize_group", "reshard_grace_state",
           "validate_resharded", "barrier_wire_bytes", "rejoin_barrier",
           "replica_variants", "implant_stale_replica",
           "ElasticController", "StagedPromotion", "RetuneController",
           "state_digest"]


def guarded_chain(grace, *, seed: int = 0, max_norm: Optional[float] = None,
                  check_state: bool = True,
                  fallback_after: Optional[int] = None,
                  fallback_steps: Optional[int] = None) -> GuardTransform:
    """``guard_transform(grace.transform(seed))`` with the guard's verdict
    OR-reduced over the grace communicator's process group, or, on a 2-D
    dp×fsdp mesh (``grace.mesh``), over the whole mesh: the per-rank state
    scans can disagree across fsdp shards too, and the fallback window must
    open on every rank or the per-shard exchanges fall out of step (the JAX
    package's psum over both axes).

    The chain is the transform followed by the train state's torch
    optimizer, which the guard steps and rolls back
    (``train.make_train_step``/``make_stateful_train_step`` take the
    result in place of a GraceTransform). ``grace`` is a
    :class:`~grace_tpu_torch.helper.Grace`; its ``escape`` (e.g.
    ``"escape": "fp16"`` in ``grace_from_params``) is the dense codec of
    the window that ``fallback_after``/``fallback_steps`` control."""
    mesh = getattr(grace, "mesh", None)
    group = (mesh.group if getattr(mesh, "is_2d", False)
             else grace.communicator.group)
    return guard_transform(grace.transform(seed=seed), max_norm=max_norm,
                           check_state=check_state,
                           fallback_after=fallback_after,
                           fallback_steps=fallback_steps, group=group)
