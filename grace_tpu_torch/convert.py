"""Carry a model's weights, and a GRACE state, from the JAX package to this
port.

Both packages keep the same parameter layout (HWIO kernels, ``(din,
dout)`` dense weights, BatchNorm ``scale``/``bias`` and ``mean``/``var``),
so the conversion is the identity on values: nested dicts of numpy arrays
become flat mappings from dotted names to tensors. Both keep the GRACE
state's ``mem``/``comp`` entries in the same order (one per leaf in the
flatten order, one per bucket of a bucketed or flat run, or one per
``'grouped'`` group, stacked along a leading axis of the group's size), so
a JAX run's residuals,
Signum momenta, PowerSGD's Q factors and the DGC memory's
``{"residual", "gradient"}`` dicts carry over entry for entry.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
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


def grace_state_from_jax(jax_state: Any, seed: int,
                         rank: Optional[int] = None):
    """A JAX ``GraceState`` (after ``jax.device_get``) → the port's
    :class:`~grace_tpu_torch.transform.GraceState`, to resume a JAX run in
    the port. ``count``, ``mem`` and ``comp`` carry over; the JAX threefry
    key does not (the port's streams hang off ``seed``, see
    ``core.LeafKey``). ``rank`` picks one rank's slice of per-rank state
    that carries a leading world axis (as ``init_train_state`` on a mesh
    builds it); None takes the arrays as they are."""
    from grace_tpu_torch.transform import GraceState
    return GraceState(
        count=int(np.asarray(jax_state.count)), seed=int(seed),
        mem=[_state_leaf(m, rank) for m in jax_state.mem],
        comp=[_state_leaf(c, rank) for c in jax_state.comp])
