"""The adaptive compression ladder; counterpart of the JAX package's
``resilience/adapt.py``.

An :class:`AdaptConfig` declares an ordered ladder of codecs, safest first:
rung 0 is always the transform's dense ``escape`` (the codec and all-reduce
of the guard's fallback window), rungs ``1..R-1`` the declared
:attr:`~AdaptConfig.ladder`, and the transform's own codec the top rung,
the steady state a quiet run returns to. Every update runs one rung through
the transform's memory, communicator and executor.

Each step, every rank's relative compression error (the telemetry row's
``compression_error``, measured against the active rung's codec; 0 on the
dense rung) is reduced over the group to a replicated mean and worst-rank
value (:func:`adapt_signal`) and accumulated into the window's statistics.
At every ``window``-th update the controller decides:

* **tighten**, one rung down, on a spike of the window's mean
  (``tighten_error``) or of the worst rank's error (``tighten_peak``), or
  on guard evidence (a step of the window under the fallback flag);
* **escalate and hold**: guard evidence also freezes loosening for
  ``hold_windows`` windows;
* **loosen**, one rung up, only after ``quiet_windows`` consecutive windows
  whose mean sits below ``loosen_error`` (under ``tighten_error``: the gap
  is the hysteresis band), with no hold in force.

Where the state lives. JAX keeps :class:`AdaptState` as replicated device
scalars and dispatches with ``lax.switch``. The port's executor is picked
on the host, as the escape's already is, so the rung and the counters
(``rung``, ``fb_steps``, ``quiet``, ``hold``, ``tightens``, ``loosens``,
``escalations``, ``last_change_step``) are host ints, the same on every
rank because every input they follow from is. The window's statistics
``err_sum`` and ``err_peak`` stay on the device, accumulated every step
with no read. At a window boundary they are copied to pinned host memory
without waiting, and the decision is made on the host where the rung is
next needed (:meth:`AdaptState.settle`, called at the start of the next
update): one wait a window, none on the other steps. The decision runs in
float32, as XLA runs it (``err_sum / window`` as a multiplication by the
float32 reciprocal, which is what jitted XLA compiles the division to).

Wire honesty: the telemetry row prices each step at the active rung and
adds the signal's cost as ``adapt_bytes`` (JAX's :func:`adapt_signal_bytes`,
the price of its ``pmean`` and ``pmax``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from grace_tpu_torch.telemetry.aggregate import _world
from grace_tpu_torch.utils.metrics import HostCopy

__all__ = ["AdaptConfig", "AdaptState", "normalize_adapt", "adapt_init",
           "adapt_signal", "adapt_signal_bytes", "adapt_advance",
           "adapt_report", "AdaptMonitor", "ADAPT_HOST_FIELDS"]

# Non-finite local errors (a poisoned gradient the guard will roll back
# anyway) clamp to this finite spike, so the accumulators stay finite and
# the boundary decision reads "tighten".
_ERR_CLAMP = 1e6

# The fields, in the JAX package's order; all but err_sum and err_peak are
# host ints.
ADAPT_FIELDS = ("rung", "err_sum", "err_peak", "fb_steps", "quiet", "hold",
                "tightens", "loosens", "escalations", "last_change_step")
ADAPT_HOST_FIELDS = tuple(f for f in ADAPT_FIELDS
                          if f not in ("err_sum", "err_peak"))


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """The controller's knobs and the declared ladder (module docstring).

    ``ladder``: the non-dense rungs as built compressors, safest first, the
    transform's own codec last (:func:`normalize_adapt` appends it). Every
    rung must keep the same mem/comp state structure as the base codec;
    PowerSGD ladders pad Q to the ladder's largest rank (``state_rank``,
    which ``grace_from_params`` sets). ``window``: updates between
    decisions. ``start_rung``: the first rung (None: the top)."""

    ladder: Tuple[Any, ...] = ()
    window: int = 10
    tighten_error: float = 0.5
    tighten_peak: float = 0.75
    loosen_error: float = 0.25
    quiet_windows: int = 2
    hold_windows: int = 4
    start_rung: Optional[int] = None

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"adapt window must be >= 1; got {self.window}")
        if not (0.0 < self.loosen_error < self.tighten_error):
            raise ValueError(
                f"adapt thresholds must satisfy 0 < loosen_error "
                f"({self.loosen_error}) < tighten_error "
                f"({self.tighten_error}) — the gap between them is the "
                "hysteresis band; equal thresholds would let the "
                "controller flap a rung per window")
        if self.tighten_peak < self.tighten_error:
            raise ValueError(
                f"tighten_peak ({self.tighten_peak}) must be >= "
                f"tighten_error ({self.tighten_error}) — the worst-rank "
                "channel is a coarser alarm than the mean, not a finer "
                "one")
        if self.quiet_windows < 1:
            raise ValueError(f"quiet_windows must be >= 1; "
                             f"got {self.quiet_windows}")
        if self.hold_windows < 0:
            raise ValueError(f"hold_windows must be >= 0; "
                             f"got {self.hold_windows}")

    @property
    def n_rungs(self) -> int:
        """Reachable rungs, the implicit dense rung 0 included."""
        return len(self.ladder) + 1

    @property
    def top_rung(self) -> int:
        return len(self.ladder)


def normalize_adapt(adapt, base_compressor) -> Optional[AdaptConfig]:
    """The knob's spellings: None/False (off), True (defaults), an int (the
    window), a dict (config kwargs; ``ladder`` holds built compressors) or
    an AdaptConfig. The base codec is appended as the top rung unless the
    ladder already ends with it."""
    if adapt is None or adapt is False:
        return None
    if adapt is True:
        cfg = AdaptConfig()
    elif isinstance(adapt, AdaptConfig):
        cfg = adapt
    elif isinstance(adapt, int):
        cfg = AdaptConfig(window=adapt)
    elif isinstance(adapt, dict):
        cfg = AdaptConfig(**{k: (tuple(v) if k == "ladder" else v)
                             for k, v in adapt.items()})
    else:
        raise TypeError(f"adapt must be None/bool/int/dict/AdaptConfig; "
                        f"got {type(adapt).__name__}")
    ladder = tuple(cfg.ladder)
    if not ladder or ladder[-1] != base_compressor:
        ladder = ladder + (base_compressor,)
    cfg = dataclasses.replace(cfg, ladder=ladder)
    if cfg.start_rung is not None and not (0 <= cfg.start_rung
                                           <= cfg.top_rung):
        raise ValueError(
            f"start_rung {cfg.start_rung} outside the ladder's rung range "
            f"[0, {cfg.top_rung}]")
    return cfg


class _Boundary:
    """A window boundary's ``[err_sum, err_peak]`` on its way to the host
    (pinned memory, copied without waiting), with what the decision needs:
    the boundary's step count and the config."""

    def __init__(self, stats: torch.Tensor, count: int,
                 config: AdaptConfig):
        self.count, self.config = count, config
        self.stats = HostCopy(stats)

    def read(self) -> Tuple[np.float32, np.float32]:
        # Waits for the boundary step only.
        err_sum, err_peak = self.stats.wait().numpy()
        return np.float32(err_sum), np.float32(err_peak)


class AdaptState:
    """The controller's state, threaded through ``GraceState.adapt`` (the
    JAX package's fields, in its order). ``err_sum`` and ``err_peak`` are
    float32 0-d device tensors; the other fields are host ints, the same on
    every rank. After a window boundary the decision is pending until
    :meth:`settle` (which the next update, the consensus audit, a
    checkpoint and :func:`adapt_report` call) reads the boundary's
    statistics and makes it, in place."""

    def __init__(self, rung: int, err_sum: torch.Tensor,
                 err_peak: torch.Tensor, fb_steps: int = 0, quiet: int = 0,
                 hold: int = 0, tightens: int = 0, loosens: int = 0,
                 escalations: int = 0, last_change_step: int = -1,
                 pending: Optional[_Boundary] = None):
        self.rung = int(rung)
        self.err_sum, self.err_peak = err_sum, err_peak
        self.fb_steps, self.quiet, self.hold = (int(fb_steps), int(quiet),
                                                int(hold))
        self.tightens, self.loosens = int(tightens), int(loosens)
        self.escalations = int(escalations)
        self.last_change_step = int(last_change_step)
        self._pending = pending

    @property
    def pending(self) -> bool:
        """Whether a boundary's decision waits for :meth:`settle`."""
        return self._pending is not None

    def settle(self) -> "AdaptState":
        """Make the pending boundary decision, if any (one wait, for the
        boundary step); returns ``self``."""
        if self._pending is not None:
            b, self._pending = self._pending, None
            _decide(self, b.config, b.count, *b.read())
        return self

    def _asdict(self) -> dict:
        self.settle()
        return {f: getattr(self, f) for f in ADAPT_FIELDS}

    def host_fields(self) -> list:
        """The host ints, settled, in the JAX package's order."""
        self.settle()
        return [getattr(self, f) for f in ADAPT_HOST_FIELDS]

    def replace(self, **changes) -> "AdaptState":
        fields = self._asdict()
        fields.update(changes)
        return AdaptState(**fields)

    def __repr__(self) -> str:
        return "AdaptState(" + ", ".join(
            f"{f}={getattr(self, f)!r}" for f in ADAPT_FIELDS) + (
            ", pending" if self.pending else "") + ")"


def adapt_init(config: AdaptConfig, device=None) -> AdaptState:
    start = (config.start_rung if config.start_rung is not None
             else config.top_rung)
    return AdaptState(
        rung=start,
        err_sum=torch.zeros((), dtype=torch.float32, device=device),
        err_peak=torch.zeros((), dtype=torch.float32, device=device))


def adapt_signal(local_err, group=None):
    """The replicated ``(mean, worst-rank)`` of each rank's local relative
    compression error, as 0-d float32 tensors: one all-gather of the
    ``(1,)`` local value, summed in rank order times the float32
    reciprocal of W (XLA's CPU psum adds in rank order, and its ``x / W``
    is that multiplication), and its max. Every rank gets the same bits.
    At one rank the local value stands in for both, with no collective."""
    from grace_tpu_torch.comm import _all_gather_into
    from grace_tpu_torch.core import mean_scale

    err = torch.as_tensor(local_err, dtype=torch.float32).reshape(())
    world = _world(group)
    if world == 1:
        return err, err
    out = torch.empty(world, dtype=torch.float32, device=err.device)
    _all_gather_into(out, err.reshape(1), group=group)
    total = out[0]
    for r in range(1, world):
        total = total + out[r]
    return total * mean_scale(world), out.amax()


def adapt_signal_bytes(world: int) -> int:
    """One rank's received bytes of one step's signal in the JAX package:
    one float32 ``pmean`` and one ``pmax``, each a full-group ring
    reduction moving ``2·4·(W−1)/W`` bytes. The telemetry row's
    ``adapt_bytes`` (the port's one all-gather receives ``4·(W−1)``)."""
    return 2 * (2 * 4 * max(0, world - 1) // max(1, world))


def _clamped(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.nan_to_num(v, nan=_ERR_CLAMP, posinf=_ERR_CLAMP,
                                        neginf=_ERR_CLAMP), max=_ERR_CLAMP)


def adapt_advance(state: AdaptState, config: AdaptConfig, count: int,
                  fallback, err_mean, err_peak) -> AdaptState:
    """One step of the controller: the new state with this step's signal
    accumulated (on the device) and, when ``count`` closes a window, the
    decision pending (the boundary's statistics on their way to the host,
    the accumulators reset). ``state`` must be settled; it is left as it
    was (the guard keeps it for a rollback)."""
    state.settle()
    err_sum = state.err_sum + _clamped(torch.as_tensor(
        err_mean, dtype=torch.float32))
    err_max = torch.maximum(state.err_peak, _clamped(torch.as_tensor(
        err_peak, dtype=torch.float32)))
    new = AdaptState(
        rung=state.rung, err_sum=err_sum, err_peak=err_max,
        fb_steps=state.fb_steps + int(bool(fallback)), quiet=state.quiet,
        hold=state.hold, tightens=state.tightens, loosens=state.loosens,
        escalations=state.escalations,
        last_change_step=state.last_change_step)
    if (int(count) + 1) % config.window == 0:
        new._pending = _Boundary(torch.stack([err_sum, err_max]),
                                 int(count), config)
        new.err_sum = torch.zeros_like(err_sum)
        new.err_peak = torch.zeros_like(err_max)
    return new


def _decide(a: AdaptState, config: AdaptConfig, count: int,
            err_sum: np.float32, err_peak: np.float32) -> None:
    """The boundary decision, in place on ``a``'s host fields, from the
    window's statistics; the JAX package's ``_decide`` in float32."""
    f32 = np.float32
    wmean = f32(err_sum) * f32(f32(1.0) / f32(config.window))
    spike = bool(wmean > f32(config.tighten_error)
                 or f32(err_peak) > f32(config.tighten_peak))
    guard_evidence = a.fb_steps > 0
    tighten = spike or guard_evidence
    rung = max(a.rung - 1, 0) if tighten else a.rung
    # Escalate-and-hold; the loosen check reads the hold before its decay.
    hold = config.hold_windows if guard_evidence else max(a.hold - 1, 0)
    quiet_now = not tighten and bool(wmean < f32(config.loosen_error))
    quiet = 0 if tighten else (a.quiet + 1 if quiet_now else 0)
    loosen = (not tighten and quiet >= config.quiet_windows and a.hold == 0
              and rung < config.top_rung)
    if loosen:
        rung, quiet = rung + 1, 0
    a.rung, a.quiet, a.hold, a.fb_steps = rung, quiet, hold, 0
    a.tightens += int(tighten)
    a.loosens += int(loosen)
    a.escalations += int(guard_evidence)
    if tighten or loosen:
        a.last_change_step = int(count)


# -- host-side reporting -------------------------------------------------------

def adapt_report(state: Any) -> dict:
    """The first armed AdaptState's counters in ``state`` (a GraceState, a
    guard's state, a train state, or dicts, lists and tuples of them)::

        {"rung", "tightens", "loosens", "escalations", "hold", "quiet",
         "last_change_step"}

    Host values; a pending boundary decision is made first (one wait). An
    empty dict when no GraceState carries one."""
    from grace_tpu_torch.resilience.consensus import _nodes
    from grace_tpu_torch.transform import GraceState

    found = [g.adapt for g in _nodes(state, GraceState)
             if g.adapt is not None]
    if not found:
        return {}
    a = found[0].settle()
    return {"rung": a.rung, "tightens": a.tightens, "loosens": a.loosens,
            "escalations": a.escalations, "hold": a.hold, "quiet": a.quiet,
            "last_change_step": a.last_change_step}


class AdaptMonitor:
    """Emits ``adapt_tighten``/``adapt_loosen`` sink records on rung
    transitions, from flushed telemetry rows: the ring's ``adapt_rung``
    column is the effective rung of each row, and this diffs consecutive
    rows. Rows inside a guard fallback window are skipped (the escape
    forces rung 0 there; that is the guard's move, not a policy one)."""

    def __init__(self, sink=None):
        self.sink = sink
        self.events: list = []
        self._last_rung: Optional[int] = None

    def observe(self, records) -> list:
        out: list = []
        for rec in records:
            if not isinstance(rec, dict) or rec.get("event") is not None:
                continue
            rung = rec.get("adapt_rung")
            if rung is None or float(rung) < 0:
                continue
            if rec.get("fallback"):
                continue
            rung = int(rung)
            if self._last_rung is not None and rung != self._last_rung:
                kind = ("adapt_tighten" if rung < self._last_rung
                        else "adapt_loosen")
                ev = {"event": kind, "step": rec.get("step"),
                      "rung": rung, "from_rung": self._last_rung}
                out.append(ev)
                self.events.append(ev)
                if self.sink is not None:
                    self.sink.write(ev)
            self._last_rung = rung
        return out
