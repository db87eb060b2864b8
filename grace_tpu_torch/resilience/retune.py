"""Online re-tuning: a configuration promotion as a two-phase transaction
with automatic rollback; counterpart of the JAX package's
``resilience/retune.py``.

The adaptive ladder moves along a fixed ladder inside the step; the tuner
picks a configuration offline. This controller moves a running job to a
different configuration when its gradients drift away from what the
incumbent was tuned on, without a restart and without betting the run on
an unproven winner:

* **Drift watch** (:meth:`RetuneController.observe`): windowed
  compression-error means against a baseline learned from the run's own
  first window; ``drift_windows`` consecutive hot windows arm a re-tune.

* **Decide** (:meth:`RetuneController.propose`): the tuner's static funnel
  (:func:`grace_tpu_torch.tuning.online.online_static`) in a child process,
  then its shortlist measured over the live group
  (:func:`~grace_tpu_torch.tuning.online.online_measure`), bounded.

* **PREPARE** (:meth:`RetuneController.prepare`): everything that can
  reject the candidate happens before any live state changes:

  1. the static auditor on the candidate
     (:func:`grace_tpu_torch.analysis.configs.audit_config`), in a child
     process: the tracer owns a fake default process group and refuses to
     run beside the training run's;
  2. the candidate's transform, its fresh state (``tx.init`` on the live
     parameters, no broadcast), and the live GraceState migrated onto it
     (:func:`~grace_tpu_torch.transform.migrate_grace_state`, every carried
     tensor cloned), with a new optimizer of the incumbent's class over
     the same parameters that carries a copy of its per-parameter state.
     The live ``TrainState`` is read, never written: the staged state
     shares only the model with it, which PREPARE does not touch;
  3. the staged state against the footprint model at the live world
     (:func:`~grace_tpu_torch.resilience.elastic.validate_resharded`);
  4. the incumbent checkpointed as last-known-good (``good=True``, the
     demotion target) and its :func:`state_digest` taken as the witness.

* **COMMIT** (:meth:`RetuneController.commit`): the staged state goes live
  behind :func:`~grace_tpu_torch.resilience.elastic.rejoin_barrier` over
  the live group (one forced fingerprint audit), and enters probation.

* **Probation** (:meth:`RetuneController.watch` /
  :meth:`RetuneController.demote`): a guard trip or a consensus
  escalation within ``probation_steps`` demotes: the last-known-good
  checkpoint is restored into a target built under the old configuration
  (the model's parameters written back in place), its digest checked
  against the PREPARE-time witness. A quiet probation clears.

Every leg (measure, checkpoint, commit, restore) runs under
:meth:`RetuneController._watchdog`, and the two child processes under
their own bounded wait: a stall is a ``retune_timeout`` record, a retry
with a doubled timeout, then the leg's exit with the last known good (an
aborted promotion, the incumbent kept), never a hang.

Event vocabulary (timeline kind ``retune``): ``retune_drift``,
``retune_measure``, ``retune_prepare``, ``retune_abort``,
``retune_promote``, ``retune_probation_clear``, ``retune_demote``,
``retune_timeout``. ``retune_promote`` and ``retune_demote`` open
incidents (:mod:`grace_tpu_torch.evidence.incident`).

The port's ``TrainState`` is a live module and optimizer, not an
immutable tree, so :func:`state_digest` walks it in
:func:`grace_tpu_torch.checkpoint.state_leaves` order: the model's
``state_dict``, the optimizer's, then the GRACE (or guard) state.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import hashlib
import multiprocessing
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from grace_tpu_torch.resilience.consensus import normalize_consensus

__all__ = ["StagedPromotion", "RetuneController", "state_digest",
           "CHILD_TIMEOUT_S"]

# The bounded wait of a child leg (the lint audit, the static funnel) when
# the controller has no leg timeout of its own: a child always ends.
CHILD_TIMEOUT_S = 600.0

# What the child legs import: the fork server that starts them imports it
# once, so each child pays for its own audit or funnel, not for torch.
_CHILD_MODULES = ("grace_tpu_torch.analysis.configs",
                  "grace_tpu_torch.tuning.online")


def _leaf_parts(leaf) -> Optional[Tuple[str, tuple, bytes]]:
    """A state leaf's numpy dtype name, shape and bytes, the parts the JAX
    package hashes (None for an absent leaf). A bfloat16 tensor, which
    numpy lacks, keeps its dtype name and its bytes."""
    if leaf is None:
        return None
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return ("bfloat16", tuple(t.shape),
                    t.view(torch.int16).numpy().tobytes())
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return str(arr.dtype), tuple(arr.shape), arr.tobytes()


def state_digest(state) -> str:
    """Order-stable sha256 of every leaf of ``state``: per leaf, its numpy
    dtype name (``float32``, not ``torch.float32``), its shape tuple, then
    its bytes, the JAX package's parts. The witness of a bit-exact
    rollback: taken at PREPARE over the incumbent, again over the restored
    state at demotion. Leaves come in
    :func:`~grace_tpu_torch.checkpoint.state_leaves` order (a dict's in
    insertion order; JAX sorts a dict's keys): over the same arrays in the
    same order, the digest equals the JAX package's."""
    from grace_tpu_torch.checkpoint import state_leaves

    h = hashlib.sha256()
    for leaf, _ in state_leaves(state).values():
        parts = _leaf_parts(leaf)
        if parts is None:
            continue
        dtype, shape, data = parts
        h.update(dtype.encode())
        h.update(str(shape).encode())
        h.update(data)
    return h.hexdigest()


def _copy_optimizer(opt: torch.optim.Optimizer,
                    carry_state: bool = True) -> torch.optim.Optimizer:
    """A copy of ``opt`` over the same parameters, with its param groups'
    settings and (``carry_state``) a copy of its per-parameter state, none
    of it aliased: the staged state's optimizer, which PREPARE builds
    without writing the live one. A deep copy with the parameters held
    shared, not a new instance through the class's constructor: an
    optimizer's ``defaults`` need not be its constructor's keywords
    (AdamW's hold ``decoupled_weight_decay``)."""
    memo: Dict[int, Any] = {id(p): p for g in opt.param_groups
                            for p in g["params"]}
    if not carry_state:
        memo[id(opt.state)] = collections.defaultdict(dict)
    return copy.deepcopy(opt, memo)


def _clone(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone()


# -- the child legs ------------------------------------------------------------

def _lint_child(conn, params: Dict[str, Any], passes, world: int) -> None:
    from grace_tpu_torch.analysis.configs import audit_config
    findings = audit_config({"name": "retune-candidate", "params": params,
                             "passes": tuple(passes)}, world=world)
    conn.send([f.message for f in findings if f.severity == "error"])
    conn.close()


def _funnel_child(conn, topology, kwargs: Dict[str, Any]) -> None:
    from grace_tpu_torch.tuning.online import online_static
    conn.send(online_static(topology, **kwargs))
    conn.close()


class _ChildDied(RuntimeError):
    """A child leg ended without a result."""


@dataclasses.dataclass
class StagedPromotion:
    """Everything PREPARE staged, nothing of which is live yet. COMMIT
    consumes it; an abort drops it (the incumbent was never written)."""

    step: int
    old_params: Dict[str, Any]
    new_params: Dict[str, Any]
    grace: Any
    tx: Any
    state: Any                       # the staged TrainState, not yet live
    migration: Dict[str, Any]
    footprint_matches: Optional[bool]
    lint_errors: int
    checkpointed: bool
    lkg_digest: Optional[str]


class RetuneController:
    """Host-side orchestrator of the drift → decide → PREPARE → COMMIT →
    probation → (clear | demote) transaction, one a rank: every rank of
    ``group`` calls the same methods at the same steps.

    ``build(grace_params) -> (grace, tx)`` is the run's own chain factory
    (``tx`` a GraceTransform or a guarded chain over ``group``); the
    controller rebuilds both sides of every cutover through it, so the
    guard and consensus wrapping the run trains with is exactly what a
    promoted configuration trains with. ``params`` is the incumbent's
    grace-params dict (the first demotion target).

    ``consensus`` arms the COMMIT barrier (None: an unaudited swap).
    ``checkpointer`` is a :class:`~grace_tpu_torch.checkpoint.Checkpointer`;
    without one PREPARE records no demotion target, and a demotion falls
    back to a fresh old-configuration state on the current parameters
    (``restored=False``). ``group`` is the live process group (None: the
    default group).

    ``leg_timeout_s``/``leg_retries`` bound every leg; ``None`` runs the
    in-process legs inline. A stalled leg's thread is abandoned, not
    stopped: a collective it has in flight is not cancelled, so at W>1 the
    group must then be rebuilt before it is used again (the JAX package's
    bounded exit stands for that). The child legs (the lint audit, on the
    card's route, and the static funnel) wait at most
    ``leg_timeout_s`` (or :data:`CHILD_TIMEOUT_S`) a try, and a stalled
    child is killed. Every PREPARE audits its candidate anew, as the JAX
    package's does.
    """

    def __init__(self, *, build: Callable[[Dict[str, Any]], Tuple[Any, Any]],
                 params: Dict[str, Any],
                 consensus=None, checkpointer=None, sink=None,
                 window: int = 8, drift_factor: float = 2.0,
                 drift_error: Optional[float] = None,
                 drift_windows: int = 2,
                 probation_steps: int = 24,
                 demote_on: Tuple[str, ...] = ("guard_skip",
                                               "guard_fallback_engaged",
                                               "consensus_escalation"),
                 leg_timeout_s: Optional[float] = None,
                 leg_retries: int = 1,
                 audit_world: int = 8,
                 group=None):
        self.build = build
        self.params = dict(params)
        self.consensus = (normalize_consensus(consensus)
                          if consensus not in (None, False) else None)
        self.checkpointer = checkpointer
        self.sink = sink
        if int(window) < 1:
            raise ValueError(f"window must be >= 1; got {window}")
        self.window = int(window)
        if float(drift_factor) <= 1.0:
            raise ValueError(f"drift_factor must be > 1 (a factor <= 1 "
                             f"re-tunes on healthy noise); got {drift_factor}")
        self.drift_factor = float(drift_factor)
        self.drift_error = (float(drift_error)
                            if drift_error is not None else None)
        self.drift_windows = max(1, int(drift_windows))
        self.probation_steps = int(probation_steps)
        self.demote_on = tuple(demote_on)
        if leg_timeout_s is not None and float(leg_timeout_s) <= 0:
            raise ValueError(f"leg_timeout_s must be positive; "
                             f"got {leg_timeout_s}")
        self.leg_timeout_s = (float(leg_timeout_s)
                              if leg_timeout_s is not None else None)
        if int(leg_retries) < 0:
            raise ValueError(f"leg_retries must be >= 0; got {leg_retries}")
        self.leg_retries = int(leg_retries)
        self.audit_world = int(audit_world)
        self.group = group

        self.phase = "idle"          # idle | prepared | probation
        self.events: List[dict] = []
        self.leg_seconds: Dict[str, float] = {}   # the last run of each leg
        self._staged: Optional[StagedPromotion] = None
        self._probation_until: Optional[int] = None
        self._demotion_params: Optional[Dict[str, Any]] = None
        self._lkg_digest: Optional[str] = None
        self._win: List[float] = []
        self._baseline: Optional[float] = None
        self._hot = 0

    # -- plumbing -------------------------------------------------------------
    def _emit(self, event: str, step: int, **payload) -> dict:
        rec = {"event": event, "step": int(step), **payload}
        self.events.append(rec)
        if self.sink is not None:
            self.sink.write(rec)
        return rec

    def _timed(self, leg: str, fn):
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            self.leg_seconds[leg] = time.perf_counter() - t0

    def _watchdog(self, leg: str, step: int, fn):
        """Run one leg bounded: ``(ok, result, timeouts)``. A daemon
        thread, a bounded wait, a doubled timeout each retry, one
        ``retune_timeout`` record per stall, and the stalled thread
        abandoned (its collectives are not cancelled; see the class
        docstring); ``ok=False`` is the caller's cue for its leg's exit.
        Exceptions from ``fn`` propagate unchanged, never retried."""
        if self.leg_timeout_s is None:
            return True, self._timed(leg, fn), 0
        timeout = self.leg_timeout_s
        timeouts = 0
        for trial in range(self.leg_retries + 1):
            done = threading.Event()
            out: List[Any] = []
            errs: List[BaseException] = []

            def run():
                try:
                    out.append(self._timed(leg, fn))
                except BaseException as e:   # noqa: BLE001 — re-raised below
                    errs.append(e)
                finally:
                    done.set()

            threading.Thread(target=run, daemon=True,
                             name=f"grace-retune-{leg}-{trial}").start()
            if done.wait(timeout):
                if errs:
                    raise errs[0]
                return True, out[0], timeouts
            timeouts += 1
            self._emit("retune_timeout", step, leg=leg, attempt=trial + 1,
                       timeout_s=float(timeout),
                       retries_left=self.leg_retries - trial)
            timeout *= 2.0
        return False, None, timeouts

    def _child(self, leg: str, step: int, target, *args):
        """Run ``target(conn, *args)`` in a process forked from the
        ``multiprocessing`` fork server, a fresh interpreter that has
        imported :data:`_CHILD_MODULES` (no default process group, no CUDA
        context of the parent's), and return what it sends: ``(ok,
        result, timeouts)``, as :meth:`_watchdog`. A child
        that outlives its wait is killed (``retune_timeout``, retried with
        a doubled wait); one that ends without a result raises
        :class:`_ChildDied`. On a group of several ranks the group's first
        rank runs the child and every rank gets its outcome (a broadcast
        over the group), so every rank takes the same branch: a verdict
        that differed across ranks would leave some at the barrier
        alone."""
        world = self._world()
        first = world == 1 or dist.get_rank(self.group) == 0
        outcome = self._run_child(leg, target, args) if first else None
        if world > 1:
            box = [outcome]
            dist.broadcast_object_list(
                box, src=(0 if self.group is None
                          else dist.get_global_rank(self.group, 0)),
                group=self.group)
            outcome = box[0]
        ok, result, stalls, died, seconds = outcome
        self.leg_seconds[leg] = seconds
        for attempt, timeout in stalls:
            self._emit("retune_timeout", step, leg=leg, attempt=attempt,
                       timeout_s=float(timeout),
                       retries_left=self.leg_retries - attempt + 1)
        if died is not None:
            raise _ChildDied(died)
        return ok, result, len(stalls)

    def _run_child(self, leg: str, target, args):
        """:meth:`_child`'s process on this rank: ``(ok, result, stalls,
        died, seconds)``, ``stalls`` the ``(attempt, timeout)`` of each
        killed try, ``died`` the reason a child gave no result."""
        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload(list(_CHILD_MODULES))
        timeout = self.leg_timeout_s or CHILD_TIMEOUT_S
        stalls: List[Tuple[int, float]] = []
        t0 = time.perf_counter()
        for trial in range(self.leg_retries + 1):
            recv, send = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=target, args=(send,) + tuple(args),
                               name=f"grace-retune-{leg}-{trial}",
                               daemon=True)
            proc.start()
            send.close()
            try:
                if recv.poll(timeout):
                    try:
                        result = recv.recv()
                    except EOFError:
                        proc.join(30)
                        return (False, None, stalls,
                                f"the {leg} child exited with code "
                                f"{proc.exitcode} and no result",
                                time.perf_counter() - t0)
                    proc.join(30)
                    return (True, result, stalls, None,
                            time.perf_counter() - t0)
            finally:
                recv.close()
                if proc.is_alive():
                    proc.kill()
                    proc.join()
            stalls.append((trial + 1, timeout))
            timeout *= 2.0
        return False, None, stalls, None, time.perf_counter() - t0

    def _reset_drift(self) -> None:
        self._win.clear()
        self._baseline = None
        self._hot = 0

    def _world(self) -> int:
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size(self.group)
        return 1

    # -- drift watch ----------------------------------------------------------
    def observe(self, step: int,
                compression_error: Optional[float]) -> bool:
        """Feed one step's compression error (a host float from the
        telemetry reader); True the first time drift is sustained:
        ``drift_windows`` consecutive window means above ``drift_factor``×
        the baseline (or above ``drift_error``). The first full window is
        the baseline."""
        if self.phase != "idle" or compression_error is None:
            return False
        self._win.append(float(compression_error))
        if len(self._win) < self.window:
            return False
        mean = sum(self._win) / len(self._win)
        self._win.clear()
        if self._baseline is None:
            self._baseline = mean
            return False
        drifting = mean > self._baseline * self.drift_factor
        if self.drift_error is not None:
            drifting = drifting or mean > self.drift_error
        if not drifting:
            self._hot = 0
            return False
        self._hot += 1
        if self._hot < self.drift_windows:
            return False
        self._hot = 0
        self._emit("retune_drift", step, window_mean=mean,
                   baseline=self._baseline,
                   drift_factor=self.drift_factor,
                   drift_windows=self.drift_windows)
        return True

    # -- decide ---------------------------------------------------------------
    def propose(self, step: int, topology, *, device="cuda",
                model: str = "toy", shortlist_n: int = 3,
                audit_world: Optional[int] = None, timed_steps: int = 4,
                repeats: int = 1, seed: int = 0,
                measure_timeout_s: Optional[float] = None,
                measure_retries: int = 1, include=None, exclude=()
                ) -> Optional[Dict[str, Any]]:
        """Re-run the tuner's funnel against the live group, bounded: the
        static funnel in a child process, then its shortlist measured over
        ``self.group`` on ``device``. Returns the
        :func:`~grace_tpu_torch.tuning.online.online_measure` document, or
        None when a leg timed out, the child died or nothing won: all
        mean "stay on the incumbent"."""
        from grace_tpu_torch.tuning.online import (ONLINE_MEASURE_TIMEOUT_S,
                                                   online_measure)

        static_kw = {"model": model, "shortlist_n": shortlist_n,
                     "audit_world": (self.audit_world if audit_world is None
                                     else int(audit_world)),
                     "include": list(include or ()),
                     "exclude": list(exclude)}
        try:
            ok, funnel, timeouts = self._child("funnel", step,
                                               _funnel_child, topology,
                                               static_kw)
        except _ChildDied as e:
            self._emit("retune_abort", step, leg="funnel",
                       reason=str(e)[:200])
            return None
        if not ok:
            self._emit("retune_abort", step, leg="funnel",
                       reason="static funnel child exceeded its bounded "
                              "wait — keeping the incumbent config",
                       timeouts=timeouts)
            return None
        mt = (ONLINE_MEASURE_TIMEOUT_S if measure_timeout_s is None
              else measure_timeout_s)
        ok, doc, timeouts = self._watchdog(
            "measure", step,
            lambda: online_measure(
                topology, funnel, self.group, device=device, model=model,
                timed_steps=timed_steps, repeats=repeats, seed=seed,
                measure_timeout_s=mt, measure_retries=measure_retries,
                include=static_kw["include"], exclude=exclude))
        if not ok:
            self._emit("retune_abort", step, leg="measure",
                       reason="measure leg exceeded its bounded wait — "
                              "keeping the incumbent config",
                       timeouts=timeouts)
            return None
        measured = doc["measured"]
        self._emit("retune_measure", step, winner=doc["winner"],
                   measured=len(measured["rows"]),
                   skipped=len(measured["skipped"]),
                   measure_timeouts=sum(
                       1 for s in measured["skipped"]
                       if s.get("verdict") == "measure_timeout"),
                   timeouts=timeouts)
        if doc["winner"] is None:
            return None
        return doc

    # -- PREPARE --------------------------------------------------------------
    def prepare(self, step: int, state, candidate_params: Dict[str, Any]
                ) -> Optional[StagedPromotion]:
        """Stage a promotion of ``state`` (a ``train.TrainState``) to
        ``candidate_params`` without writing it; the staged transaction,
        or None when a gate rejected the candidate (recorded as a
        ``retune_abort``; the run continues on the incumbent)."""
        if self.phase == "probation":
            raise RuntimeError("prepare() during probation — clear or "
                               "demote the in-flight promotion first.")
        from grace_tpu_torch.analysis.passes import PASS_NAMES
        from grace_tpu_torch.resilience.elastic import validate_resharded
        from grace_tpu_torch.train import TrainState
        from grace_tpu_torch.transform import migrate_grace_state

        candidate_params = dict(candidate_params)
        world = self._world()

        # Gate 1: the static auditor, in a child. Escape- and
        # adapt-carrying candidates skip wire_reconciliation, as their
        # registry entries do: a dense fallback or a ladder makes the wire
        # cost multi-modal by design.
        passes = tuple(PASS_NAMES)
        if candidate_params.get("escape") or candidate_params.get("adapt"):
            passes = tuple(p for p in PASS_NAMES
                           if p != "wire_reconciliation")
        try:
            ok, errors, timeouts = self._child(
                "lint", step, _lint_child, candidate_params, passes,
                self.audit_world)
        except _ChildDied as e:
            self._emit("retune_abort", step, leg="lint",
                       reason=str(e)[:200])
            return None
        if not ok:
            self._emit("retune_abort", step, leg="lint",
                       reason="lint child exceeded its bounded wait — "
                              "keeping the incumbent config",
                       timeouts=timeouts)
            return None
        if errors:
            self._emit("retune_abort", step, leg="lint",
                       reason=errors[0][:200], lint_errors=len(errors))
            return None

        # Gate 2: build and migrate onto a fresh state. No broadcast (that
        # would write the live model): the parameters are replicated
        # already. Every carried tensor is cloned.
        t0 = time.perf_counter()
        grace, tx = self.build(candidate_params)
        named = dict(state.model.named_parameters())
        fresh = tx.init(named)
        try:
            migrated, mig = migrate_grace_state(state.grace, fresh,
                                                convert=_clone)
        except ValueError as e:
            self._emit("retune_abort", step, leg="migrate",
                       reason=str(e)[:200])
            return None
        staged_state = TrainState(state.model,
                                  _copy_optimizer(state.optimizer), migrated)

        # Gate 3: the staged state against the footprint model at the live
        # world under the new configuration.
        try:
            footprint = validate_resharded(staged_state, grace, named,
                                           world)["matches"]
        except ValueError as e:
            self._emit("retune_abort", step, leg="footprint",
                       reason=str(e)[:200])
            return None
        self.leg_seconds["migrate"] = time.perf_counter() - t0

        # Leg 4 (bounded): the incumbent checkpointed while the group is
        # whole, the demotion target. A stall degrades the rollback (an
        # older good checkpoint may exist) but does not block the
        # promotion, and the event says so.
        checkpointed, ck_timeouts = False, 0
        lkg_digest = None
        if self.checkpointer is not None:
            lkg_digest = state_digest(state)

            def save():
                self.checkpointer.save(step, state, force=True, good=True)
                self.checkpointer.wait()

            checkpointed, _, ck_timeouts = self._watchdog(
                "prepare_checkpoint", step, save)

        staged = StagedPromotion(
            step=step, old_params=dict(self.params),
            new_params=candidate_params, grace=grace, tx=tx,
            state=staged_state, migration=mig,
            footprint_matches=footprint, lint_errors=0,
            checkpointed=checkpointed, lkg_digest=lkg_digest)
        self._staged = staged
        self.phase = "prepared"
        self._emit("retune_prepare", step,
                   candidate=candidate_params.get("compressor"),
                   lint_errors=0, footprint_matches=footprint,
                   checkpointed=checkpointed,
                   checkpoint_timeouts=ck_timeouts,
                   mem_carried=mig["mem"]["carried"],
                   mem_overlap=mig["mem"]["overlap"],
                   mem_fresh=mig["mem"]["fresh"],
                   comp_carried=mig["comp"]["carried"],
                   comp_overlap=mig["comp"]["overlap"],
                   comp_fresh=mig["comp"]["fresh"])
        return staged

    # -- COMMIT ---------------------------------------------------------------
    def commit(self, step: int):
        """Cut over to the staged promotion behind the consensus barrier
        over the live group. Returns ``(state, (grace, tx), event)`` with
        the staged state live and probation armed, or None when the commit
        leg timed out (the promotion dropped; the incumbent keeps running,
        untouched by PREPARE)."""
        if self.phase != "prepared" or self._staged is None:
            raise RuntimeError("commit() without a staged promotion — "
                               "call prepare() first.")
        staged = self._staged

        def cutover():
            if self.consensus is None:
                return staged.state, None
            from grace_tpu_torch.resilience.elastic import rejoin_barrier
            return rejoin_barrier(staged.state, self.consensus, self.group)

        ok, result, timeouts = self._watchdog("commit", step, cutover)
        if not ok:
            self._staged = None
            self.phase = "idle"
            self._emit("retune_abort", step, leg="commit",
                       reason="commit barrier exceeded its bounded wait "
                              "— promotion dropped, incumbent config "
                              "keeps running",
                       timeouts=timeouts)
            return None
        state, report = result
        self._demotion_params = staged.old_params
        self._lkg_digest = staged.lkg_digest
        self.params = dict(staged.new_params)
        self._probation_until = step + self.probation_steps
        self.phase = "probation"
        self._reset_drift()
        barrier = {}
        if report is not None:
            barrier = {k: report[k] for k in
                       ("repairs", "barrier_repairs", "audits",
                        "replica_variants", "fingerprint_bytes",
                        "repair_bytes") if k in report}
        event = self._emit("retune_promote", step,
                           old=staged.old_params.get("compressor"),
                           new=staged.new_params.get("compressor"),
                           probation_until=self._probation_until,
                           commit_timeouts=timeouts, **barrier)
        self._staged = None
        return state, (staged.grace, staged.tx), event

    # -- probation ------------------------------------------------------------
    def watch(self, step: int, records) -> Optional[str]:
        """Feed the run's sink records during probation; the triggering
        event's name the moment a guard trip or consensus escalation
        demands demotion (call :meth:`demote`), else None. A probation
        that reaches its horizon quiet clears the transaction."""
        if self.phase != "probation":
            return None
        for rec in records or ():
            ev = str(rec.get("event", ""))
            if any(ev == t or ev.startswith(t + "_") for t in self.demote_on):
                return ev
        if (self._probation_until is not None
                and step >= self._probation_until):
            self.phase = "idle"
            self._probation_until = None
            self._emit("retune_probation_clear", step,
                       config=self.params.get("compressor"))
        return None

    def demote(self, step: int, state, *, trigger: str):
        """Roll back: the last-known-good checkpoint restored into a
        target built under the old configuration (a fresh optimizer of the
        live one's class over the same parameters, the old transform's
        fresh state; the model's parameters are written back in place),
        its digest checked against the PREPARE-time witness. A stalled or
        absent restore falls back to a fresh old-configuration state on
        the current parameters (``restored=False``). Returns ``(state,
        (grace, tx), event)``."""
        if self.phase != "probation" or self._demotion_params is None:
            raise RuntimeError("demote() without a probationary promotion.")
        from grace_tpu_torch.train import TrainState

        old_params = self._demotion_params
        grace, tx = self.build(old_params)
        named = dict(state.model.named_parameters())

        def target():
            return TrainState(state.model,
                              _copy_optimizer(state.optimizer,
                                              carry_state=False),
                              tx.init(named))

        restored_state = None
        restored, timeouts, bit_exact = False, 0, None
        if self.checkpointer is not None:
            ok, out, timeouts = self._watchdog(
                "demote_restore", step,
                lambda: self.checkpointer.restore_last_good(target()))
            if ok:
                restored_state, restored = out, True
                if self._lkg_digest is not None:
                    bit_exact = state_digest(restored_state) == \
                        self._lkg_digest
        if restored_state is None:
            restored_state = target()
        self.params = dict(old_params)
        self._demotion_params = None
        self._lkg_digest = None
        self._probation_until = None
        self.phase = "idle"
        self._reset_drift()
        event = self._emit("retune_demote", step, trigger=trigger,
                           restored=restored, bit_exact=bit_exact,
                           restore_timeouts=timeouts,
                           config=old_params.get("compressor"))
        return restored_state, (grace, tx), event
