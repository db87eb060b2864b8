"""The non-finite step guard with an atomic rollback of error feedback;
counterpart of the JAX package's ``resilience/guard.py``.

Error feedback makes training stateful: a NaN that reaches a residual is
fed back by ``compensate`` on every later step. :func:`guard_transform`
wraps the GRACE transform and the torch optimizer that applies its
updates, and checks what the step produced: the update the optimizer
applied to the parameters (``p_new − p_old``; JAX checks the optax chain's
update, which is the same on a finite step), and, with ``check_state``,
the new GRACE and optimizer state, the telemetry ring left out. A bad step
leaves the parameters, the optimizer state and every GraceState tensor
(``mem``, ``comp``, the ring, the step counter) exactly as they were; a
healthy step passes through bit for bit.

The port decides on the device, as JAX does inside its jitted step: the bad
flag, its OR over the group (one all-reduce) and the counters are device
tensors, and every rollback is a ``torch.where`` on the flag. Two things
JAX also keeps on the device live on the host here: the GRACE step counter
(it keys the codecs' random streams) and the fallback flag (it picks the
escape's branch). The guard copies the step's ``[bad, fallback]`` pair to
pinned host memory without waiting and reads it where it is first needed:
at the next step's exchange, after that step's backward pass is queued,
when the copy has long landed (:meth:`GuardState.settle`).

The kernels write state in place on CUDA: chunk Top-K and the sign-pack
overwrite the residual they are given, and torch optimizers update the
parameters and their moments in place. So the guard copies every tensor it
may have to restore before the step (the snapshot), and selects between
the copy and the new value after it. State that lives on the host (Adam's
``step`` counter, the adaptive controller's rung and counters) and state a
bad first step created (SGD's momentum buffer) are restored when the pair
is read, before anything uses them.

Degradation: ``fallback_after`` (K) consecutive bad steps set the
``fallback`` flag of every GraceState for the next ``fallback_steps`` (M)
updates, which then run the transform's dense ``escape``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

from grace_tpu_torch.telemetry import counters
from grace_tpu_torch.telemetry.aggregate import WatchState
from grace_tpu_torch.telemetry.scopes import STAGE_APPLY, trace_stage
from grace_tpu_torch.telemetry.state import TelemetryState
from grace_tpu_torch.transform import (GraceState, GraceTransform,
                                       _state_tensors)
from grace_tpu_torch.utils.metrics import HostCopy

__all__ = ["GuardState", "GuardTransform", "guard_transform",
           "GUARD_ROLLBACK_EXCLUDED", "GUARD_SCAN_EXCLUDED_TYPES"]

# What a bad step writes through instead of restoring: the guard's own
# counters (recording the bad step is their job) and the GraceState
# fallback flag, a decision for the next step made after the rollback.
GUARD_ROLLBACK_EXCLUDED = ("notfinite_count", "last_bad_step",
                           "consecutive", "fallback_remaining", "step",
                           "fallback")

# The state scan's exclusion: the node types of
# transform.GRACE_OBSERVATIONAL_FIELDS (telem -> TelemetryState, watch ->
# WatchState). The rings record a poisoned gradient's norm as it is; they
# must not flip a step bad on their own, and they still roll back.
GUARD_SCAN_EXCLUDED_TYPES = (TelemetryState, WatchState)

_COUNTERS = ("notfinite_count", "last_bad_step", "consecutive",
             "fallback_remaining", "step")


class _Pending:
    """A guarded step's ``[bad, fallback]`` flags on their way to the host,
    and the host-side restores a bad step needs: ``(dict, key, value)``,
    ``value`` None to delete the key; ``adapt``: the adaptive controller's
    state before the step, which a bad step keeps."""

    def __init__(self, flags: torch.Tensor, restores: list, adapt=None):
        self.restores, self.adapt = restores, adapt
        self.flags = HostCopy(flags)

    def read(self):
        # Waits for this step only.
        bad, fallback = (bool(v) for v in self.flags.wait().tolist())
        if bad:
            for d, key, value in self.restores:
                if value is None:
                    d.pop(key, None)
                else:
                    d[key] = value
        return bad, fallback


class GuardState:
    """The wrapped transform's state and the guard's counters (JAX's
    ``GuardState`` fields, int32 device scalars): ``notfinite_count``
    (skipped steps), ``last_bad_step`` (-1: none), ``consecutive``,
    ``fallback_remaining`` (escape steps left) and ``step``.

    ``inner`` is the GraceState as of the last step: reading it settles
    that step (:meth:`settle`), which waits for the step's two flags.
    ``host_step`` is ``step`` kept on the host: it advances on every call,
    skipped steps too, so the host knows it without a read (the consensus
    audit's clock); None reads it from ``step``."""

    def __init__(self, inner: GraceState, notfinite_count, last_bad_step,
                 consecutive, fallback_remaining, step,
                 pending: Optional[_Pending] = None,
                 host_step: Optional[int] = None):
        self._inner = inner
        self.notfinite_count = notfinite_count
        self.last_bad_step = last_bad_step
        self.consecutive = consecutive
        self.fallback_remaining = fallback_remaining
        self.step = step
        self._pending = pending
        self.host_step = int(step) if host_step is None else host_step

    def settle(self) -> None:
        """Fix the host half of the last step: the GRACE counter advances
        only if the step was accepted, the fallback flag becomes the
        guard's verdict, and a bad step's host-side state is restored."""
        if self._pending is None:
            return
        pending, self._pending = self._pending, None
        bad, fallback = pending.read()
        # A bad step's controller state is the one before it: its window
        # statistics untouched on the device (the step wrote new tensors)
        # and its host ints, a boundary decision of the step discarded.
        self._inner = dataclasses.replace(
            self._inner, count=self._inner.count + (0 if bad else 1),
            fallback=fallback,
            adapt=pending.adapt if bad else self._inner.adapt)

    @property
    def inner(self) -> GraceState:
        self.settle()
        return self._inner

    def replace(self, **changes) -> "GuardState":
        self.settle()
        fields = {"inner": self._inner, "host_step": self.host_step,
                  **{name: getattr(self, name) for name in _COUNTERS}}
        fields.update(changes)
        return GuardState(**fields)

    def escalate(self, steps: int) -> "GuardState":
        """This state with the dense window armed for at least ``steps``
        more updates, as the consensus audit escalates a repeat offender:
        ``fallback_remaining`` raised to ``steps`` on the device and the
        GraceState's ``fallback`` set, so the next update already runs the
        escape and the guard's countdown owns the window from there."""
        self.settle()
        return self.replace(
            inner=dataclasses.replace(self._inner, fallback=True),
            fallback_remaining=torch.clamp(self.fallback_remaining,
                                           min=int(steps)))

    def counters(self) -> torch.Tensor:
        """The five counters as one int32 device tensor, in JAX's order."""
        return torch.stack([getattr(self, name) for name in _COUNTERS])


def _floating(tensors) -> list:
    return [t for t in tensors if t.is_floating_point() and t.numel()]


def _nonfinite(tensors, device) -> torch.Tensor:
    """A device bool: any NaN or ±Inf in any floating tensor. Each
    tensor's max |x| is NaN or +Inf exactly then (a max propagates NaN,
    and a finite max cannot overflow, where a sum of squares could): one
    multi-tensor launch over every tensor."""
    ts = _floating(tensors)
    if not ts:
        return torch.zeros((), dtype=torch.bool, device=device)
    peaks = torch._foreach_norm(ts, float("inf"))
    return ~torch.isfinite(torch.stack([n.float() for n in peaks])).all()


_INTS = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as the integer type of its width: a select through
    these views moves bit patterns (a NaN's, a ``-0.0``'s) as they are."""
    return t.view(_INTS[t.element_size()])


@dataclasses.dataclass(frozen=True)
class GuardTransform:
    """The guarded chain: ``inner`` (a GraceTransform) followed by the
    torch optimizer given to :meth:`apply`. See :func:`guard_transform`."""

    inner: GraceTransform
    max_norm: Optional[float] = None
    check_state: bool = True
    fallback_after: Optional[int] = None
    fallback_steps: Optional[int] = None
    group: Optional[Any] = None
    # Reused from step to step: the snapshot's buffers and integer views of
    # the tensors the rollback writes (keyed by the tensors' ids).
    _reused: dict = dataclasses.field(default_factory=dict, compare=False,
                                       repr=False)

    def _snapshot(self, tensors: list) -> list:
        """Copies of ``tensors`` in buffers kept from the previous step (one
        multi-tensor copy; new buffers when the shapes or dtypes change)."""
        sig = [(t.shape, t.dtype) for t in tensors]
        if self._reused.get("sig") != sig:
            bufs = [torch.empty_like(t) for t in tensors]
            self._reused.update(sig=sig, bufs=bufs,
                                 bits=[_bits(b) for b in bufs])
        if tensors:
            torch._foreach_copy_(self._reused["bufs"], tensors)
        return self._reused["bufs"]

    def _bits_of(self, tensors: list) -> list:
        """Integer views of ``tensors``, the previous step's where the same
        tensor comes again (a parameter, a residual a kernel overwrote)."""
        seen = self._reused.get("views", {})
        views, out = {}, []
        for t in tensors:
            hit = seen.get(id(t))
            if hit is None or hit[0] is not t \
                    or hit[1].data_ptr() != t.data_ptr():
                hit = (t, _bits(t))
            views[id(t)] = hit
            out.append(hit[1])
        self._reused["views"] = views
        return out

    def _restore(self, bad: torch.Tensor, tensors: list) -> None:
        """``tensors[i] = snapshot[i] if bad else tensors[i]``, in place and
        bit for bit, ``bad`` a device bool: ``x·(1−bad) + s·bad`` over the
        integer views (exact: one term is 0), in three multi-tensor
        launches where a ``torch.where`` a tensor makes one launch each.
        The snapshot's buffers end up zeroed or spent."""
        if not tensors:
            return
        bad_i = bad.to(torch.int32)
        snaps = self._reused["bits"]
        ints = self._bits_of(tensors)
        torch._foreach_mul_(snaps, bad_i)
        torch._foreach_mul_(ints, 1 - bad_i)
        torch._foreach_add_(ints, snaps)

    def init(self, params: Mapping[str, torch.Tensor]) -> GuardState:
        grace = self.inner.init(params)
        device = next(iter(params.values())).device if params else None
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return GuardState(inner=grace, notfinite_count=zero,
                          last_bad_step=zero - 1, consecutive=zero.clone(),
                          fallback_remaining=zero.clone(), step=zero.clone(),
                          host_step=0)

    def _world(self) -> int:
        if not (dist.is_available() and dist.is_initialized()):
            return 1
        return dist.get_world_size(self.group)

    def apply(self, params: Mapping[str, torch.nn.Parameter],
              grads: Mapping[str, torch.Tensor], state: GuardState,
              optimizer: torch.optim.Optimizer) -> GuardState:
        """One guarded step: the GRACE exchange of ``grads``, the
        optimizer's step on the exchanged updates (each parameter's
        ``.grad``), the verdict, and the rollback of a bad step. Returns
        the new state; nothing waits for the device."""
        old = state.inner                     # settles the previous step
        device = state.step.device
        ps = list(params.values())
        with torch.no_grad():
            before = [dict(optimizer.state.get(p, {})) for p in ps]
            # The optimizer's device state is restored on the device; what
            # lives on the host (Adam's step) when the flags are read.
            kept = [(p, k) for p, st in zip(ps, before) for k, v in st.items()
                    if torch.is_tensor(v) and v.device == device]
            host = [(p, k, v.clone()) for p, st in zip(ps, before)
                    for k, v in st.items()
                    if torch.is_tensor(v) and v.device != device]
            data = [p.detach() for p in ps]
            snaps = self._snapshot(
                data + [optimizer.state[p][k] for p, k in kept]
                + _state_tensors(old.mem) + _state_tensors(old.comp))

        updates, new = self.inner.update(grads, old)
        for name, p in params.items():
            p.grad = updates[name]
        with trace_stage(STAGE_APPLY):
            optimizer.step()

        with torch.no_grad():
            # The update is non-finite exactly when the new parameters are
            # (the old ones are: a step that made them otherwise was
            # rolled back).
            grace_new = _state_tensors(new.mem) + _state_tensors(new.comp)
            scanned = list(data)
            if self.check_state:
                scanned += grace_new + [
                    v for p in ps for v in optimizer.state.get(p, {})
                    .values() if torch.is_tensor(v) and v.device == device]
            bad = _nonfinite(scanned, device)
            if self.max_norm is not None:
                deltas = _floating(torch._foreach_sub(data, snaps[:len(ps)]))
                norm = torch.stack([n.float() for n in torch._foreach_norm(
                    deltas)]).square().sum().sqrt()
                bad = bad | (norm > self.max_norm)
            if self._world() > 1:
                flag = bad.to(torch.int32)
                counters.count("all_reduce", flag)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
                bad = flag > 0

            # The rollback, written into the live tensors: the parameters,
            # the optimizer's device state, and the new GRACE tensors (the
            # old ones themselves where a kernel wrote in place).
            self._restore(bad, [p for p in ps]
                          + [optimizer.state[p][k] for p, k in kept]
                          + grace_new)
            restores = [(optimizer.state[p], k, v) for p, k, v in host]
            for p, st in zip(ps, before):
                restores += [(optimizer.state[p], k, None)
                             for k in optimizer.state.get(p, {})
                             if k not in st]          # created this step
                restores += [(optimizer.state[p], k, v) for k, v in st.items()
                             if not torch.is_tensor(v)]
            # The rings roll back by selection (each update writes new
            # ones and leaves the old).
            telem, watch = new.telem, new.watch
            if telem is not None:
                telem = TelemetryState(
                    rings=torch.where(bad, old.telem.rings, telem.rings),
                    steps=torch.where(bad, old.telem.steps, telem.steps))
            if watch is not None:
                watch = WatchState(
                    rings=torch.where(bad, old.watch.rings, watch.rings),
                    steps=torch.where(bad, old.watch.steps, watch.steps))

            # The counters, as JAX advances them.
            bad_i = bad.to(torch.int32)
            notfinite = state.notfinite_count + bad_i
            last_bad = torch.where(bad, state.step, state.last_bad_step)
            consecutive = torch.where(bad, state.consecutive + 1,
                                      torch.zeros_like(state.consecutive))
            active = (state.fallback_remaining > 0).to(torch.int32)
            remaining = state.fallback_remaining - active
            if self.fallback_after is not None:
                trip = (consecutive >= self.fallback_after) & (remaining == 0)
                remaining = torch.where(
                    trip, torch.full_like(remaining, self.fallback_steps),
                    remaining)
                consecutive = torch.where(trip, torch.zeros_like(consecutive),
                                          consecutive)
            flags = torch.stack([bad_i, (remaining > 0).to(torch.int32)])
        inner = dataclasses.replace(old, mem=new.mem, comp=new.comp,
                                    telem=telem, watch=watch,
                                    adapt=new.adapt)
        return GuardState(inner=inner, notfinite_count=notfinite,
                          last_bad_step=last_bad, consecutive=consecutive,
                          fallback_remaining=remaining,
                          step=state.step + 1,
                          pending=_Pending(flags, restores, old.adapt),
                          host_step=state.host_step + 1)


def guard_transform(inner: GraceTransform, *,
                    max_norm: Optional[float] = None,
                    check_state: bool = True,
                    fallback_after: Optional[int] = None,
                    fallback_steps: Optional[int] = None,
                    group: Optional[Any] = None) -> GuardTransform:
    """Wrap a GRACE transform, and the torch optimizer that applies its
    updates, in the non-finite step guard (module docstring).

    A step is bad when the applied update holds a NaN or Inf, when its
    global norm exceeds ``max_norm`` (if set), or, with ``check_state``,
    when the new GRACE or optimizer state holds one. ``group``: OR the
    verdict over this process group (the update is the same on every rank;
    the states are per rank). ``fallback_after``/``fallback_steps`` (K/M):
    after K consecutive bad steps, the next M updates take the transform's
    dense escape (they need ``escape=...``; the flag is harmless without
    one)."""
    if (fallback_after is None) != (fallback_steps is None):
        raise ValueError("fallback_after (K) and fallback_steps (M) must be "
                         "set together")
    return GuardTransform(inner, max_norm=max_norm, check_state=check_state,
                          fallback_after=fallback_after,
                          fallback_steps=fallback_steps, group=group)
