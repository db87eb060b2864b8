"""One flat gradient buffer through the GRACE exchange: ``GraceBridge``.

Counterpart of the JAX package's ``GraceBridge``. There, one jitted XLA
program runs the pipeline over a ``(world, n)`` array on a mesh, fed from
numpy; here the process is one rank of a ``torch.distributed`` group and
the buffer stays on its device. The bridge holds one ``fusion='flat'``
transform over the buffer and its ``GraceState`` between calls.

    bridge = GraceBridge(grace_from_params({...}, group=group), n=numel)
    agg = bridge.exchange(local_flat_grads)      # aggregated, on the device
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from grace_tpu_torch.parallel import resolve_device
from grace_tpu_torch.transform import GraceState, grace_transform

__all__ = ["GraceBridge"]


def _layout(value):
    """The (shape, dtype) skeleton of a state entry."""
    if isinstance(value, torch.Tensor):
        return (tuple(value.shape), value.dtype)
    if isinstance(value, dict):
        return {k: _layout(v) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return tuple(_layout(v) for v in value)
    return value if value is None else type(value).__name__


class GraceBridge:
    """The GRACE pipeline over one flat gradient buffer of ``n`` elements.

    ``grace`` is a :class:`grace_tpu_torch.helper.Grace` (its communicator
    exchanges over its own group); ``group`` is the process group whose rank
    picks this process's row in :meth:`exchange_global` (None: the
    communicator's). The buffer lives on ``device``, which defaults to the
    card; pass ``device="cpu"`` for the plain versions over gloo."""

    def __init__(self, grace, n: int, group: Optional[Any] = None,
                 seed: int = 0, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        if grace.routes:
            raise ValueError("GraceBridge exchanges one flat buffer; "
                             "per-leaf routes need the leaves: use "
                             "GraceTransform.update")
        self.grace = grace
        self.n = int(n)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.group = group if group is not None else grace.communicator.group
        self.world = dist.get_world_size(self.group)
        self._tx = grace_transform(grace.compressor, grace.memory,
                                   grace.communicator, seed=seed,
                                   fusion="flat")
        self._state = self._tx.init({"flat": torch.zeros(
            self.n, dtype=dtype, device=self.device)})

    def exchange(self, local_flat_grads) -> torch.Tensor:
        """This rank's ``(n,)`` gradients → the aggregated ``(n,)`` tensor
        on the bridge's device, the state advanced one step."""
        local = torch.as_tensor(local_flat_grads).to(self.device, self.dtype)
        if tuple(local.shape) != (self.n,):
            raise ValueError(f"expected flat gradients of shape ({self.n},), "
                             f"got {tuple(local.shape)}")
        out, self._state = self._tx.update({"flat": local}, self._state)
        return out["flat"]

    def exchange_global(self, global_grads) -> torch.Tensor:
        """Exchange a ``(world, n)`` array of every rank's gradients: each
        rank feeds its own row (in the JAX package one process feeds them
        all)."""
        g = torch.as_tensor(global_grads)
        if tuple(g.shape) != (self.world, self.n):
            raise ValueError(f"expected ({self.world}, {self.n}), "
                             f"got {tuple(g.shape)}")
        return self.exchange(g[dist.get_rank(self.group)])

    @property
    def state(self) -> GraceState:
        """The compression state (residuals and codec state), for
        checkpoints. Copy it before the next exchange: on the card the
        chunk Top-K kernel writes the new residual over the old one."""
        return self._state

    @state.setter
    def state(self, value: GraceState):
        # Fail at assignment, not deep inside the next exchange.
        expect = (_layout(self._state.mem), _layout(self._state.comp))
        got = (_layout(value.mem), _layout(value.comp))
        if expect != got:
            raise ValueError(
                "restored grace state does not match this bridge's layout "
                f"(n={self.n}, world={self.world}); expected "
                f"{expect}, got {got}")
        self._state = value
