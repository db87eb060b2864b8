"""Carry a model's weights from the JAX package to this port.

Both packages keep the same parameter layout (HWIO kernels, ``(din,
dout)`` dense weights, BatchNorm ``scale``/``bias`` and ``mean``/``var``),
so the conversion is the identity on values: nested dicts of numpy arrays
become flat mappings from dotted names to tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

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
