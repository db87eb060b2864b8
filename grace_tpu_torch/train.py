"""Training steps: forward and backward, the GRACE exchange, the optimizer.

Counterpart of the JAX package's ``train.py`` (``make_train_step``,
``make_stateful_train_step`` and their state initialisers). The JAX step is
one jitted SPMD program over a mesh; here each process runs one rank's
step eagerly and the communicators' collectives join the ranks. One step:

1. forward and backward on the local batch;
2. (stateful) the model's buffers, e.g. BatchNorm running stats, averaged
   over the group so they stay replicated;
3. the GRACE exchange of every gradient leaf (``GraceTransform.update``);
4. the optimizer step on the exchanged updates (``torch.optim.SGD(lr)``
   is ``optax.sgd(lr)``);
5. the loss averaged over the group.

The exchanged update replaces each parameter's ``.grad`` in place of the
local gradient, which the exchange consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from grace_tpu_torch.transform import GraceState, GraceTransform

__all__ = ["TrainState", "make_train_step", "make_stateful_train_step",
           "make_eval_step", "init_train_state", "init_stateful_train_state"]


@dataclasses.dataclass
class TrainState:
    model: nn.Module                  # parameters and buffers (BN stats)
    optimizer: torch.optim.Optimizer  # over model.parameters()
    grace: GraceState                 # per-leaf error-feedback state


def _src_rank(group) -> int:
    return 0 if group is None else dist.get_global_rank(group, 0)


def init_train_state(model: nn.Module, grace_tx: GraceTransform,
                     optimizer: torch.optim.Optimizer,
                     group: Optional[Any] = None) -> TrainState:
    """Replicate the model from the group's first rank (the JAX package
    replicates params over the mesh) and initialise the GRACE state."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t, src=_src_rank(group), group=group)
    return TrainState(model, optimizer,
                      grace_tx.init(dict(model.named_parameters())))


# Models with BatchNorm stats carry them as buffers of the same module.
init_stateful_train_state = init_train_state


def _mean_over_group(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.div_(dist.get_world_size(group))


def _make_step(loss_fn, grace_tx: GraceTransform, group,
               sync_model_state: bool):
    def step(state: TrainState, batch):
        model = state.model
        model.train()
        named = dict(model.named_parameters())
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        if sync_model_state:
            with torch.no_grad():
                for buf in model.buffers():
                    if buf.is_floating_point():
                        _mean_over_group(buf, group)
        grads = {}
        for name, p in named.items():
            if p.grad is None:
                raise ValueError(f"parameter {name!r} got no gradient")
            grads[name] = p.grad
        updates, grace = grace_tx.update(grads, state.grace)
        for name, p in named.items():
            p.grad = updates[name]
        state.optimizer.step()
        loss = _mean_over_group(loss.detach().clone(), group)
        return TrainState(model, state.optimizer, grace), loss

    return step


def make_train_step(loss_fn: Callable[[nn.Module, Any], torch.Tensor],
                    grace_tx: GraceTransform, group: Optional[Any] = None):
    """``step(state, batch) -> (state, loss)``. ``loss_fn(model, batch)``
    returns the mean loss over the local batch."""
    return _make_step(loss_fn, grace_tx, group, sync_model_state=False)


def make_stateful_train_step(loss_fn: Callable[[nn.Module, Any], torch.Tensor],
                             grace_tx: GraceTransform,
                             group: Optional[Any] = None,
                             sync_model_state: bool = True):
    """Like :func:`make_train_step` for models whose buffers change in the
    forward pass (BatchNorm running stats); ``sync_model_state`` averages
    them over the group after each backward pass."""
    return _make_step(loss_fn, grace_tx, group, sync_model_state)


def make_eval_step(metric_fn: Callable[[nn.Module, Any], Any],
                   group: Optional[Any] = None):
    """``eval_step(model, batch) -> metrics averaged over the group``.

    ``metric_fn(model, batch)`` returns a scalar tensor or a dict of them,
    computed on this rank's part of the batch; each is averaged over the
    group (the JAX package's ``pmean``). The model runs in eval mode
    without gradients, and its mode is restored afterwards."""

    def eval_step(model: nn.Module, batch):
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                metrics = metric_fn(model, batch)
        finally:
            model.train(was_training)
        if isinstance(metrics, dict):
            return {k: _mean_over_group(torch.as_tensor(v).detach().float()
                                        .clone(), group)
                    for k, v in metrics.items()}
        return _mean_over_group(torch.as_tensor(metrics).detach().float()
                                .clone(), group)

    return eval_step
