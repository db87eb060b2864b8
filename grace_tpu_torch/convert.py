"""Carry a model's weights, and a GRACE state, from the JAX package to this
port.

Both packages keep the same parameter layout (HWIO kernels, ``(din,
dout)`` dense weights, BatchNorm ``scale``/``bias`` and ``mean``/``var``),
so the conversion is the identity on values: nested dicts and lists of
numpy arrays become flat mappings from dotted names to tensors (a list's
members by index, as ``nn.ModuleList`` names them). Both keep the GRACE
state's ``mem``/``comp`` entries in the same order (one per leaf in the
flatten order, one per bucket of a bucketed or flat run, or one per
``'grouped'`` group, stacked along a leading axis of the group's size), so
a JAX run's residuals,
Signum momenta, PowerSGD's Q factors and the DGC memory's
``{"residual", "gradient"}`` dicts carry over entry for entry, with the
fallback flag, the telemetry ring, the adaptive controller's state and a
guard's counters.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Dicts by key and lists by index (``layers.<i>.``, the names an
    ``nn.ModuleList`` gives its members), down to the arrays."""
    items = (tree.items() if isinstance(tree, Mapping)
             else enumerate(tree))
    out = {}
    for key, value in items:
        name = f"{prefix}{key}"
        if isinstance(value, (Mapping, list, tuple)):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = torch.from_numpy(np.array(value, copy=True))
    return out


def from_jax(params_np: Mapping[str, Any], model_state_np: Mapping[str, Any]
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``(params, model_state)`` pytrees of numpy arrays (e.g. the JAX
    ResNet's parameters and BatchNorm state after ``jax.device_get``) →
    ``(state_dict, buffers)`` keyed like the port's ``named_parameters`` and
    ``named_buffers``. Load both with
    ``model.load_state_dict({**state_dict, **buffers})``."""
    return _flatten(params_np), _flatten(model_state_np)


def _state_leaf(value, rank: Optional[int]):
    """One ``mem``/``comp`` entry: None, an array (a residual, a momentum,
    a PowerSGD Q), or a dict of arrays (the DGC memory's)."""
    if value is None:
        return None
    if isinstance(value, Mapping):
        return {k: _state_leaf(v, rank) for k, v in value.items()}
    a = np.asarray(value)
    if rank is not None:
        a = a[rank]
    return torch.from_numpy(np.array(a, copy=True))


def _find_grace(tree):
    """The first GraceState-like node (``count``, ``mem`` and ``comp``) in
    a JAX optimizer state: a chain's tuple of states, or the state itself."""
    if all(hasattr(tree, a) for a in ("count", "mem", "comp")):
        return tree
    if isinstance(tree, (tuple, list)):
        for t in tree:
            found = _find_grace(t)
            if found is not None:
                return found
    return None


def grace_state_from_jax(jax_state: Any, seed: int,
                         rank: Optional[int] = None):
    """A JAX ``GraceState`` (after ``jax.device_get``) → the port's
    :class:`~grace_tpu_torch.transform.GraceState`, to resume a JAX run in
    the port. ``count``, ``mem``, ``comp``, ``fallback``, the telemetry
    ring, the consensus ``AuditState`` (as host ints), the adaptive
    ``AdaptState`` (its window statistics as float32 scalars, the rest as
    host ints) and the watch ring carry over; the JAX threefry key does
    not (the port's streams hang off ``seed``, see ``core.LeafKey``). A JAX guard's ``GuardState``
    becomes the port's, its counters as int32 scalars, wrapping the
    GraceState found in its chain state. ``rank`` picks one rank's slice
    of per-rank state that carries a leading world axis (as
    ``init_train_state`` on a mesh builds it); None takes the arrays as
    they are. Everything lands on the CPU."""
    from grace_tpu_torch.resilience.guard import _COUNTERS, GuardState
    from grace_tpu_torch.telemetry.aggregate import WatchState
    from grace_tpu_torch.telemetry.state import TelemetryState
    from grace_tpu_torch.transform import AuditState, GraceState

    if hasattr(jax_state, "notfinite_count"):
        return GuardState(
            inner=grace_state_from_jax(_find_grace(jax_state.inner), seed,
                                       rank),
            **{name: torch.tensor(int(np.asarray(getattr(jax_state, name))),
                                  dtype=torch.int32)
               for name in _COUNTERS})
    telem = getattr(jax_state, "telem", None)
    if telem is not None:
        telem = TelemetryState(rings=_state_leaf(telem.rings, rank),
                               steps=_state_leaf(telem.steps, rank))
    watch = getattr(jax_state, "watch", None)
    if watch is not None:
        watch = WatchState(rings=_state_leaf(watch.rings, rank),
                           steps=_state_leaf(watch.steps, rank))
    audit = getattr(jax_state, "audit", None)
    if audit is not None:       # replicated: one value on every rank
        audit = AuditState(*(int(np.asarray(v).reshape(-1)[0])
                             for v in audit))
    adapt = getattr(jax_state, "adapt", None)
    if adapt is not None:       # replicated, like the audit
        from grace_tpu_torch.resilience.adapt import AdaptState
        adapt = AdaptState(**{
            name: (torch.tensor(np.float32(np.asarray(v).reshape(-1)[0]))
                   if name in ("err_sum", "err_peak")
                   else int(np.asarray(v).reshape(-1)[0]))
            for name, v in adapt._asdict().items()})
    return GraceState(
        count=int(np.asarray(jax_state.count)), seed=int(seed),
        mem=[_state_leaf(m, rank) for m in jax_state.mem],
        comp=[_state_leaf(c, rank) for c in jax_state.comp],
        fallback=bool(np.asarray(getattr(jax_state, "fallback", False))),
        telem=telem, audit=audit, watch=watch, adapt=adapt)
