"""Elastic training: drain, resize and rejoin; counterpart of the JAX
package's ``resilience/elastic.py``.

* **Early warning → drain** (:class:`ElasticController`): the watch's
  ``watch_anomaly`` records single out a degrading rank before it dies.
  Once one rank has ``anomaly_threshold`` codec-skew episodes, the
  controller takes a last-known-good checkpoint while every rank is still
  there to write its file.

* **World resize → re-shard** (:func:`reshard_grace_state`): the
  replicated state (the parameters, the optimizer's state, a guard's
  counters and the GraceState fields ``count``, ``seed``, ``fallback``,
  ``audit``) carries over bit for bit
  (:func:`grace_tpu_torch.transform.carry_replicated`); the per-rank
  state (residuals, compressor state, the rings) is re-initialized at the
  new world by the new transform's ``init``, never re-partitioned: a
  departed rank's residual is compression error only its own stream owed,
  and error feedback re-accumulates from zero. The adaptive controller's
  state, replicated but learned at the old world's signal, is
  re-initialized too. :func:`validate_resharded` checks the result against
  the footprint model.

* **Rejoin barrier** (:func:`rejoin_barrier`): a rank that comes back was
  restored from a checkpoint the fleet has trained past. The barrier forces
  one consensus audit over the grown group: a stale replica is repaired bit
  for bit from the reference, its residuals zeroed, before its gradients
  count.

The JAX package resizes meshes of one program; the port resizes process
groups, one rank a process. The new group's rank k is old rank
``survivors[k]``; ``torch.distributed.new_group`` is a collective of every
process, so the departing ranks call :func:`resize_group` too, and get None
back (and None from :func:`reshard_grace_state`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from grace_tpu_torch.core import Topology
from grace_tpu_torch.resilience.consensus import (_nodes, _rank_world,
                                                  _view, _view_nbytes,
                                                  audit_report,
                                                  fingerprint_tree,
                                                  force_audit,
                                                  normalize_consensus)
from grace_tpu_torch.transform import GraceState, _graft, carry_replicated

__all__ = ["ResizePlan", "plan_resize", "resize_group",
           "reshard_grace_state", "validate_resharded", "barrier_wire_bytes",
           "rejoin_barrier", "implant_stale_replica", "replica_variants",
           "ElasticController"]


def _reinit_adapt(carried_tree, fresh_tree):
    """``carried_tree`` with each GraceState's ``adapt`` taken from the
    fresh init: the one replicated field a resize does not carry (its
    window statistics and rung were learned at the old world)."""
    return _graft(carried_tree, fresh_tree,
                  lambda c, f: dataclasses.replace(c, adapt=f.adapt),
                  lambda x: x, "reshard_grace_state")


def _grace_world(tree) -> Optional[int]:
    """The world the first GraceState in ``tree`` was initialized at, or
    None when none records one."""
    worlds = [g.world for g in _nodes(tree, GraceState)
              if g.world is not None]
    return worlds[0] if worlds else None


def _member(group) -> bool:
    return group is not None and group != dist.GroupMember.NON_GROUP_MEMBER


# -- resize planning -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResizePlan:
    """One world resize, decided before any state is touched.

    ``survivors``: old ranks in ascending order; the new world's rank k is
    old rank ``survivors[k]``. ``topology``: the surviving link layout
    (:meth:`Topology.shrink`: whole slices lost keep ``slice_size``, whole
    regions lost keep both tiers, partial losses collapse to flat)."""

    old_world: int
    new_world: int
    lost_ranks: Tuple[int, ...]
    survivors: Tuple[int, ...]
    topology: Topology
    whole_slices: bool
    whole_regions: bool = False


def plan_resize(world: int, lost_ranks,
                topology: Optional[Topology] = None) -> ResizePlan:
    """Plan the W→W′ resize that removes ``lost_ranks``: the loss checked
    against the link layout and the survivors renumbered. Pure logic."""
    topo = topology if topology is not None else Topology()
    lost = tuple(sorted(set(int(r) for r in lost_ranks)))
    new_topo, new_world = topo.shrink(world, lost)
    lost_set = set(lost)
    survivors = tuple(r for r in range(world) if r not in lost_set)
    whole = (topo.slice_size is not None
             and new_topo.slice_size == topo.slice_size)
    whole_regions = False
    if lost and topo.region_size is not None \
            and world % topo.region_size == 0:
        rz = topo.region_size
        touched = sorted({r // rz for r in lost})
        whole_regions = all(rho * rz + i in lost_set
                            for rho in touched for i in range(rz))
    return ResizePlan(old_world=world, new_world=new_world,
                      lost_ranks=lost, survivors=survivors,
                      topology=new_topo, whole_slices=whole,
                      whole_regions=whole_regions)


def resize_group(plan: ResizePlan, old_group=None, backend=None):
    """The survivors' process group, their old order kept (new rank k is
    old rank ``plan.survivors[k]``). ``torch.distributed.new_group`` is a
    collective of every process of the job: every rank, departing ones
    included, calls this at the same point. Returns None on a departing
    rank."""
    _, world = _rank_world(old_group)
    if world != plan.old_world:
        raise ValueError(f"resize_group: the plan resizes a world of "
                         f"{plan.old_world} ranks but the old group has "
                         f"{world}")
    ranks = [dist.get_global_rank(old_group, r) if old_group is not None
             else r for r in plan.survivors]
    group = dist.new_group(ranks=ranks, backend=backend)
    return group if _member(group) else None


# -- the re-shard -----------------------------------------------------------------

def reshard_grace_state(state, tx, old_group, new_group, params=None):
    """This rank's state re-sharded from ``old_group``'s world onto
    ``new_group``'s (None, or a group this rank is not in: the rank
    departs, and gets None back).

    ``state`` is a ``train.TrainState`` (the survivor's model and torch
    optimizer carry over as they are), or a GRACE state tree (a
    GraceState, a guard's state) with the model's ``params`` given.
    ``tx`` is the transform or guarded chain for the new world, built on
    ``new_group`` (building it is also the wire model's one invalidation
    point). The replicated GraceState fields, a guard's counters and every
    other leaf carry over bit for bit; ``mem``, ``comp``, ``telem`` and
    ``watch`` come from ``tx.init`` at the new world (residuals zero,
    compressor state freshly built: zeros are not a valid PowerSGD Q,
    rings reset), and so does ``adapt``. Check the result with
    :func:`validate_resharded`."""
    grace = state.grace if hasattr(state, "grace") else state
    _, old_world = _rank_world(old_group)
    state_world = _grace_world(grace)
    if state_world is not None and state_world != old_world:
        raise ValueError(
            f"reshard_grace_state: the state's per-rank GraceState leaves "
            f"carry world axis {state_world} but old_group has "
            f"{old_world} ranks — pass the group the state was built on.")
    if not _member(new_group):
        return None
    if hasattr(state, "grace"):
        params = dict(state.model.named_parameters())
    elif params is None:
        raise ValueError("reshard_grace_state: a GRACE state tree needs "
                         "params= (the model's named parameters)")
    fresh = tx.init(params)
    new_grace = _reinit_adapt(carry_replicated(grace, fresh), fresh)
    if hasattr(state, "grace"):
        return dataclasses.replace(state, grace=new_grace)
    return new_grace


def validate_resharded(state, grace_or_tx, params, world: int) -> dict:
    """Check a (re-)sharded state against the footprint model at
    ``world`` (:func:`grace_tpu_torch.profiling.expected_state_footprint`,
    the JAX package's flow pass 7 model): the live bytes are this rank's
    per-rank state times the world it was initialized at. Raises
    ``ValueError`` naming each component (mem/comp/telem) whose bytes
    disagree; returns ``{"live", "model", "matches": True}``."""
    from grace_tpu_torch.profiling import (expected_state_footprint,
                                           grace_state_footprint)

    tree = state.grace if hasattr(state, "grace") else state
    if params is None and hasattr(state, "model"):
        params = dict(state.model.named_parameters())
    live = grace_state_footprint(tree, _grace_world(tree) or 1)
    model = expected_state_footprint(grace_or_tx, params, world=world)
    bad = {k: (live[k], model[k])
           for k in ("mem_bytes", "comp_bytes", "telem_bytes")
           if live[k] != model[k]}
    if bad:
        detail = ", ".join(f"{k}: live {lv} != model {mv}"
                           for k, (lv, mv) in sorted(bad.items()))
        raise ValueError(
            f"re-sharded GraceState does not match the static footprint "
            f"model at world {world} ({detail}) — the state was "
            "re-initialized at a different world or under a different "
            "codec/fusion/telemetry config than the one being validated.")
    return {"live": live, "model": model, "matches": True}


# -- the rejoin barrier -----------------------------------------------------------

def barrier_wire_bytes(state, consensus, world: int) -> Dict[str, int]:
    """The wire price of one rejoin barrier at ``world``: the fingerprint
    exchange every rank pays, and the repair broadcast of the replicated
    state, paid only when a rejoiner diverges (the scheduled audit's two
    terms, at the JAX package's widths)."""
    config = normalize_consensus(consensus)
    leaves, graces = [], []
    _view(state, leaves, graces)
    return {"fingerprint_bytes": int(world) * 2 * config.segments * 4,
            "repair_bytes": _view_nbytes(leaves, graces)}


def _params(state) -> list:
    if hasattr(state, "model"):
        return [p.detach() for p in state.model.parameters()]
    return [t.detach() for t in (state.values() if isinstance(state, dict)
                                 else state)]


def replica_variants(state, group=None) -> int:
    """The largest number of distinct bit patterns any parameter leaf has
    across the ranks of ``group`` (1: every replica is bit-identical, the
    invariant after the barrier). One fingerprint of the parameters, leaf
    ``i`` alone in segment ``i``, gathered over the group: one read."""
    from grace_tpu_torch.comm import _all_gather_into

    leaves = _params(state)
    if not leaves:
        return 1
    fp = fingerprint_tree(leaves, segments=len(leaves))
    _, world = _rank_world(group)
    if world > 1:
        out = torch.empty(world * fp.numel(), dtype=fp.dtype,
                          device=fp.device)
        _all_gather_into(out, fp, group=group)
        fp = out
    words = fp.view(world, 2, len(leaves)).cpu().numpy()
    return max(len({tuple(words[r, :, i]) for r in range(world)})
               for i in range(len(leaves)))


def implant_stale_replica(state, rank: int, stale_params, group=None):
    """On group rank ``rank``, overwrite this replica's parameters in place
    with ``stale_params`` (name → tensor, the rejoiner's restored
    checkpoint); the other ranks keep theirs. The rejoin simulation
    primitive: it builds the divergence :func:`rejoin_barrier` must
    repair. Returns ``state``."""
    named = dict(state.model.named_parameters())
    if sorted(named) != sorted(stale_params):
        raise ValueError(
            f"stale params have {len(stale_params)} leaves but the live "
            f"state has {len(named)} — restore the stale checkpoint into "
            "the same params structure first.")
    if _rank_world(group)[0] == rank:
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(stale_params[name])
    return state


def rejoin_barrier(state, consensus, group=None, check: bool = True):
    """Admission gate for a world grown back: one forced consensus audit
    (:func:`~grace_tpu_torch.resilience.consensus.force_audit`) over
    ``state`` (a ``train.TrainState``) on ``group``, repairing any rank
    whose replicated state differs from the reference. Returns ``(state,
    report)``: the post-barrier
    :func:`~grace_tpu_torch.resilience.consensus.audit_report` with the
    barrier's own ``barrier_repairs``, ``replica_variants`` and its wire
    price. ``check``: raise ``RuntimeError`` if replicas still differ
    after the repair."""
    config = normalize_consensus(consensus)
    if config is None:
        raise ValueError("rejoin_barrier requires an armed consensus "
                         "config — the fingerprint audit IS the gate.")
    pre_repairs = audit_report(state).get("repairs", 0)
    new_state = force_audit(state, config, group)
    report = dict(audit_report(new_state))
    # The barrier's own repairs: audit_report counts over the whole run.
    report["barrier_repairs"] = report.get("repairs", 0) - pre_repairs
    report["replica_variants"] = replica_variants(new_state, group)
    report.update(barrier_wire_bytes(new_state, config,
                                     _rank_world(group)[1]))
    if check and report["replica_variants"] > 1:
        raise RuntimeError(
            "rejoin barrier failed: params replicas still hold "
            f"{report['replica_variants']} distinct byte patterns after "
            "the forced audit — the rejoining rank must not be admitted. "
            f"(report: {report})")
    return new_state, report


# -- the host-loop controller -----------------------------------------------------

class ElasticController:
    """Host-side orchestrator of the drain → resize → rejoin lifecycle, one
    a rank (every rank feeds it the same records and takes the same
    decisions). :meth:`observe` takes the ``watch_anomaly`` records of the
    watch monitor and elects a drain candidate once one rank accumulates
    ``anomaly_threshold`` skew episodes in ``anomaly_metrics``;
    :meth:`drain` saves the last-known-good checkpoint while the fleet is
    whole; :meth:`resize` runs :func:`reshard_grace_state` (and
    :func:`validate_resharded`); :meth:`rejoin` runs the barrier. Every
    transition is appended to :attr:`events` and written to ``sink`` as an
    ``elastic_drain``/``elastic_resize``/``elastic_rejoin`` record, which
    the timeline classifies ``elastic``.

    With a ``topology`` that has a ``region_size``, :meth:`region_scope`
    widens a drain to the whole region once ``region_quorum`` of its ranks
    carry skew episodes. With ``drain_timeout_s`` the drain's save runs
    under a watchdog: a stall writes an ``elastic_drain_timeout`` record
    and retries with a doubled timeout, ``drain_retries`` times, then
    proceeds with the last good checkpoint on disk."""

    def __init__(self, *, consensus=None, checkpointer=None, sink=None,
                 anomaly_threshold: int = 2,
                 anomaly_metrics=("compression_error", "residual_norm"),
                 topology: Optional[Topology] = None,
                 region_quorum: float = 0.5,
                 drain_timeout_s: Optional[float] = None,
                 drain_retries: int = 1, group=None):
        self.consensus = normalize_consensus(consensus) \
            if consensus not in (None, False) else None
        self.checkpointer = checkpointer
        self.sink = sink
        self.anomaly_threshold = int(anomaly_threshold)
        # Only codec-health skews count: grad_norm skews are data
        # heterogeneity on fixed shards, not a dying rank.
        self.anomaly_metrics = tuple(anomaly_metrics)
        self.topology = topology
        if not (0.0 < float(region_quorum) <= 1.0):
            raise ValueError(f"region_quorum must be in (0, 1]; "
                             f"got {region_quorum}")
        self.region_quorum = float(region_quorum)
        if drain_timeout_s is not None and float(drain_timeout_s) <= 0:
            raise ValueError(f"drain_timeout_s must be positive; "
                             f"got {drain_timeout_s}")
        self.drain_timeout_s = (float(drain_timeout_s)
                                if drain_timeout_s is not None else None)
        if int(drain_retries) < 0:
            raise ValueError(f"drain_retries must be >= 0; "
                             f"got {drain_retries}")
        self.drain_retries = int(drain_retries)
        self.group = group
        self.events: List[dict] = []
        self.episodes: Dict[int, int] = {}
        self.drained_ranks: set = set()

    def _emit(self, event: str, step: int, **payload) -> dict:
        rec = {"event": event, "step": int(step), **payload}
        self.events.append(rec)
        if self.sink is not None:
            self.sink.write(rec)
        return rec

    # -- early warning --------------------------------------------------------
    def observe(self, step: int, anomalies) -> Optional[int]:
        """Feed new ``watch_anomaly`` dicts; returns the rank to drain the
        first time one rank's skew-episode count crosses the threshold
        (None otherwise)."""
        for a in anomalies or ():
            if a.get("kind") != "skew":
                continue
            if (self.anomaly_metrics
                    and a.get("metric") not in self.anomaly_metrics):
                continue
            rank = a.get("rank")
            if rank is None or int(rank) < 0:
                continue
            rank = int(rank)
            self.episodes[rank] = self.episodes.get(rank, 0) + 1
            if (self.episodes[rank] >= self.anomaly_threshold
                    and rank not in self.drained_ranks):
                self.drained_ranks.add(rank)
                return rank
        return None

    def region_scope(self, rank: int) -> Tuple[int, ...]:
        """The drain scope the flagged rank implies: its whole region when
        the controller knows a region layout and ``region_quorum`` of the
        region's ranks carry skew episodes, else ``(rank,)``."""
        rank = int(rank)
        topo = self.topology
        if topo is None or getattr(topo, "region_size", None) is None:
            return (rank,)
        rz = int(topo.region_size)
        rho = rank // rz
        members = tuple(range(rho * rz, (rho + 1) * rz))
        hot = sum(1 for m in members if self.episodes.get(m, 0) > 0)
        need = max(1, int(math.ceil(self.region_quorum * rz)))
        return members if hot >= need else (rank,)

    # -- lifecycle --------------------------------------------------------------
    def _drain_checkpoint(self, step: int, state) -> Tuple[bool, int]:
        """Save and wait for the last-known-good checkpoint, under a
        watchdog when ``drain_timeout_s`` is set. Returns
        ``(checkpointed, timeouts)``. A stalled attempt's thread is a
        daemon, left behind, never joined on the drain path."""
        def attempt():
            self.checkpointer.save(step, state, force=True, good=True)
            self.checkpointer.wait()

        if self.drain_timeout_s is None:
            attempt()
            return True, 0

        import threading
        timeout = self.drain_timeout_s
        timeouts = 0
        for trial in range(self.drain_retries + 1):
            done = threading.Event()
            errs: List[BaseException] = []

            def run():
                try:
                    attempt()
                except BaseException as e:   # noqa: BLE001 — re-raised below
                    errs.append(e)
                finally:
                    done.set()

            threading.Thread(target=run, daemon=True).start()
            if done.wait(timeout):
                if errs:
                    raise errs[0]
                return True, timeouts
            timeouts += 1
            last_good = None
            if hasattr(self.checkpointer, "last_good_step"):
                try:
                    last_good = self.checkpointer.last_good_step()
                except Exception:
                    last_good = None
            self._emit("elastic_drain_timeout", step, attempt=trial + 1,
                       timeout_s=float(timeout),
                       retries_left=self.drain_retries - trial,
                       last_good_step=last_good)
            timeout *= 2.0
        return False, timeouts

    def drain(self, step: int, state, rank: int, scope=None) -> dict:
        """Pre-death drain: save the last-known-good checkpoint while the
        flagged scope still takes part (every rank of the group calls it:
        each writes its file). Every rank of ``scope`` (default: the
        flagged one) is marked drained."""
        scope = (tuple(int(r) for r in scope)
                 if scope is not None else (int(rank),))
        self.drained_ranks.update(scope)
        checkpointed, timeouts = (self._drain_checkpoint(step, state)
                                  if self.checkpointer is not None
                                  else (False, 0))
        return self._emit("elastic_drain", step, rank=int(rank),
                          scope=list(scope),
                          episodes=self.episodes.get(int(rank), 0),
                          checkpointed=checkpointed,
                          drain_timeouts=timeouts)

    def resize(self, step: int, state, tx, old_group, new_group,
               plan: ResizePlan, grace=None, params=None
               ) -> Tuple[Any, dict]:
        """Run a resize plan on this rank: :func:`reshard_grace_state` onto
        ``new_group`` (None on a departing rank) and, when ``grace`` is
        given, :func:`validate_resharded` at the new world."""
        new_state = reshard_grace_state(state, tx, old_group, new_group,
                                        params)
        footprint_ok = None
        if grace is not None and new_state is not None:
            footprint_ok = validate_resharded(
                new_state, grace, params, plan.new_world)["matches"]
        event = self._emit(
            "elastic_resize", step,
            old_world=plan.old_world, new_world=plan.new_world,
            lost_ranks=list(plan.lost_ranks),
            slice_size=plan.topology.slice_size,
            region_size=plan.topology.region_size,
            whole_slices=plan.whole_slices,
            whole_regions=plan.whole_regions,
            footprint_matches=footprint_ok)
        return new_state, event

    def rejoin(self, step: int, state, group=None) -> Tuple[Any, dict]:
        """Run the consensus-gated rejoin barrier over the grown group."""
        if self.consensus is None:
            raise ValueError("ElasticController.rejoin needs an armed "
                             "consensus config (the fingerprint audit IS "
                             "the admission gate).")
        new_state, report = rejoin_barrier(
            state, self.consensus, group if group is not None
            else self.group)
        self._emit("elastic_rejoin", step, **{
            k: report[k] for k in ("repairs", "barrier_repairs", "audits",
                                   "last_divergent_rank",
                                   "replica_variants",
                                   "fingerprint_bytes", "repair_bytes")})
        return new_state, report
