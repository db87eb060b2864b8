"""Training steps: forward and backward, the GRACE exchange, the optimizer.

Counterpart of the JAX package's ``train.py`` (``make_train_step``,
``make_stateful_train_step`` and their state initialisers). The JAX step is
one jitted SPMD program over a mesh; here each process runs one rank's
step eagerly and the communicators' collectives join the ranks. One step:

1. forward and backward on the local batch;
2. (stateful) the model's buffers, e.g. BatchNorm running stats, averaged
   over the group so they stay replicated;
3. the GRACE exchange of every gradient leaf (``GraceTransform.update``);
4. the optimizer step on the exchanged updates. ``torch.optim.SGD(lr)``
   is ``optax.sgd(lr)``; ``torch.optim.AdamW(lr, betas=(0.9, 0.999),
   eps=1e-8, weight_decay=1e-4)`` is ``optax.adamw(lr)`` (optax's decay
   is 1e-4, torch's default 1e-2); ``torch.optim.SGD(lr, momentum=0.9,
   nesterov=True, weight_decay=wd)`` is ``optax.chain(
   add_decayed_weights(wd), sgd(lr, momentum=0.9, nesterov=True))``. A
   schedule's rate is set before each update with :func:`set_lr`;
5. the loss averaged over the group.

The exchanged update replaces each parameter's ``.grad`` in place of the
local gradient, which the exchange consumes.

Resilience: pass a guarded chain
(``grace_tpu_torch.resilience.guarded_chain(grace, ...)``) where a
``GraceTransform`` goes, as the JAX package's train step takes a guarded
optax chain. Steps 3 and 4 then run inside the guard, which skips a bad
step and rolls back the parameters, the optimizer state and the GRACE
state together; ``TrainState.grace`` holds its ``GuardState``, and the
loop reads its health with ``utils.metrics.guard_report(state)``.

Consistency: ``consensus=`` (None, True, ``audit_every``, a dict or a
``resilience.ConsensusConfig``) runs the cross-rank audit after step 4 (and
after the guard): every ``audit_every`` steps it fingerprints the
parameters (with the model's buffers in the stateful step), the
optimizer's state and every GraceState, and repairs a divergent rank
(:mod:`grace_tpu_torch.resilience.consensus`). The transform must carry an
``AuditState`` (``grace_from_params({"consensus": ...})``).

Sharded models (the JAX package's dp×fsdp track): pass ``mesh=`` (a
:class:`~grace_tpu_torch.transform.MeshSpec` from
``parallel.make_mesh((dp, fsdp))``) and ``param_specs=`` (a parameter name
→ the dimension it is split on over fsdp, or None for replicated; JAX's
``P("fsdp", None)`` is dim 0). The model then holds this rank's shards
(``shard_params`` cuts them from whole tensors), the optimizer and the
GraceState are built on them, so residuals are per shard by construction,
and ``loss_fn`` owns its cross-shard collectives over ``mesh.fsdp_group``
(``parallel.psum`` and ``parallel.all_gather``, whose backward passes sum
the cotangents over the group as JAX's transposes of ``psum`` and a tiled
``all_gather`` do, the fsdp width's factor included). The batch a rank
passes is the rows of its dp index (``mesh.dp_rows``: both fsdp shards of
a dp row see the same rows); the parameters broadcast, the loss and the
model's buffers average, and the audit runs over the dp group only, so
replicas match per fsdp shard. The guard's verdict spans the whole mesh
(``resilience.guarded_chain``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from grace_tpu_torch.telemetry import counters
from grace_tpu_torch.telemetry.scopes import (STAGE_APPLY, STAGE_BACKWARD,
                                              STAGE_BUFFER_MEAN,
                                              STAGE_CONSENSUS, STAGE_FORWARD,
                                              STAGE_FWD_BWD, STAGE_LOSS_MEAN,
                                              STAGE_OPTIMIZER, STAGE_STEP,
                                              trace_stage)
from grace_tpu_torch.transform import GraceState, GraceTransform, MeshSpec

__all__ = ["TrainState", "make_train_step", "make_stateful_train_step",
           "make_eval_step", "init_train_state", "init_stateful_train_state",
           "shard_params", "warmup_schedule", "set_lr"]


@dataclasses.dataclass
class TrainState:
    model: nn.Module                  # parameters and buffers (BN stats)
    optimizer: torch.optim.Optimizer  # over model.parameters()
    grace: Any                        # GraceState, or a guard's GuardState


def _src_rank(group) -> int:
    return 0 if group is None else dist.get_global_rank(group, 0)


def _dp_group(group, mesh: Optional[MeshSpec]):
    """The group the step's replicated collectives run over: the mesh's dp
    group when a bound mesh is given, else ``group``."""
    if mesh is None or not mesh.bound:
        return group
    if group is not None and group is not mesh.dp_group:
        raise ValueError("group= and mesh= disagree: on a mesh the step "
                         "runs over mesh.dp_group; pass the mesh alone")
    return mesh.dp_group


def _check_specs(named, param_specs) -> None:
    """Raise ``ValueError`` unless every ``param_specs`` entry names a
    parameter and a dimension of its shard (or None)."""
    specs = dict(param_specs or {})
    unknown = sorted(set(specs) - set(named))
    if unknown:
        raise ValueError(f"param_specs names no parameter of the model: "
                         f"{unknown}")
    for name, dim in specs.items():
        if dim is not None and not -named[name].dim() <= dim \
                < named[name].dim():
            raise ValueError(f"param_specs[{name!r}] = {dim} is not a "
                             f"dimension of its {named[name].dim()}-D shard")


def shard_params(params: Dict[str, torch.Tensor], param_specs,
                 mesh: MeshSpec) -> Dict[str, torch.Tensor]:
    """This rank's shards of whole parameters: each named tensor split
    evenly on its ``param_specs`` dimension over the fsdp axis
    (``mesh.local_shard``), a tensor without a spec whole. The JAX
    package's ``NamedSharding`` placement of ``init_train_state``."""
    specs = dict(param_specs or {})
    return {n: mesh.local_shard(t, specs.get(n)) for n, t in params.items()}


def init_train_state(model: nn.Module, grace_tx: GraceTransform,
                     optimizer: torch.optim.Optimizer,
                     group: Optional[Any] = None,
                     mesh: Optional[MeshSpec] = None,
                     param_specs=None) -> TrainState:
    """Replicate the model from the group's first rank (the JAX package
    replicates params over the mesh) and initialise the GRACE state.

    On a mesh (module docstring) the model holds this rank's shards; they
    and the replicated parameters broadcast over the dp group from its
    first rank, and the GRACE state is initialised on the local shards
    (the JAX package's ``init_opt_state`` over ``param_specs``)."""
    group = _dp_group(group, mesh)
    named = dict(model.named_parameters())
    _check_specs(named, param_specs)
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t, src=_src_rank(group), group=group)
    return TrainState(model, optimizer, grace_tx.init(named))


# Models with BatchNorm stats carry them as buffers of the same module.
init_stateful_train_state = init_train_state


def _mean_over_group(t: torch.Tensor, group) -> torch.Tensor:
    counters.count("all_reduce", t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.div_(dist.get_world_size(group))


def _make_step(loss_fn, grace_tx: GraceTransform, group,
               sync_model_state: bool, consensus=None, mesh=None,
               param_specs=None):
    group = _dp_group(group, mesh)
    if consensus is not None and consensus is not False:
        # Lazy: resilience imports transform, as this module does.
        from grace_tpu_torch.resilience.consensus import (consensus_step,
                                                          normalize_consensus)
        consensus = normalize_consensus(consensus)
    else:
        consensus = None

    unchecked = [param_specs is not None]

    def step(state: TrainState, batch):
        with trace_stage(STAGE_STEP):
            return _step(state, batch)

    def _step(state: TrainState, batch):
        model = state.model
        model.train()
        named = dict(model.named_parameters())
        if unchecked[0]:                  # the first step's model
            _check_specs(named, param_specs)
            unchecked[0] = False
        state.optimizer.zero_grad(set_to_none=True)
        with trace_stage(STAGE_FWD_BWD):
            with trace_stage(STAGE_FORWARD):
                loss = loss_fn(model, batch)
            with trace_stage(STAGE_BACKWARD):
                loss.backward()
        if sync_model_state:
            with torch.no_grad(), trace_stage(STAGE_BUFFER_MEAN):
                for buf in model.buffers():
                    if buf.is_floating_point():
                        _mean_over_group(buf, group)
        grads = {}
        for name, p in named.items():
            if p.grad is None:
                raise ValueError(f"parameter {name!r} got no gradient")
            grads[name] = p.grad
        with trace_stage(STAGE_OPTIMIZER):
            apply = getattr(grace_tx, "apply", None)
            if apply is not None:         # a guarded chain steps itself
                grace = apply(named, grads, state.grace, state.optimizer)
            else:
                updates, grace = grace_tx.update(grads, state.grace)
                for name, p in named.items():
                    p.grad = updates[name]
                with trace_stage(STAGE_APPLY):
                    state.optimizer.step()
        if consensus is not None:
            with trace_stage(STAGE_CONSENSUS):
                # The model's buffers are replicated state only where the
                # step keeps them so (the stateful step's averaging).
                model_state = (model if sync_model_state
                               else dict(model.named_parameters()))
                _, _, grace = consensus_step(
                    (model_state, state.optimizer, grace), consensus, group)
        with trace_stage(STAGE_LOSS_MEAN):
            loss = _mean_over_group(loss.detach().clone(), group)
        return TrainState(model, state.optimizer, grace), loss

    return step


def make_train_step(loss_fn: Callable[[nn.Module, Any], torch.Tensor],
                    grace_tx: GraceTransform, group: Optional[Any] = None,
                    consensus=None, mesh: Optional[MeshSpec] = None,
                    param_specs=None):
    """``step(state, batch) -> (state, loss)``. ``loss_fn(model, batch)``
    returns the mean loss over the local batch. ``grace_tx`` is a
    GraceTransform or a guarded chain, ``consensus`` the audit's config,
    ``mesh`` and ``param_specs`` the sharded-model layout (module
    docstring)."""
    return _make_step(loss_fn, grace_tx, group, sync_model_state=False,
                      consensus=consensus, mesh=mesh,
                      param_specs=param_specs)


def make_stateful_train_step(loss_fn: Callable[[nn.Module, Any], torch.Tensor],
                             grace_tx: GraceTransform,
                             group: Optional[Any] = None,
                             sync_model_state: bool = True, consensus=None,
                             mesh: Optional[MeshSpec] = None,
                             param_specs=None):
    """Like :func:`make_train_step` for models whose buffers change in the
    forward pass (BatchNorm running stats); ``sync_model_state`` averages
    them over the group (the dp group on a mesh) after each backward pass,
    and the audit then fingerprints them too."""
    return _make_step(loss_fn, grace_tx, group, sync_model_state,
                      consensus=consensus, mesh=mesh,
                      param_specs=param_specs)


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


def warmup_schedule(base_lr: float, world_size: int, warmup_steps: int,
                    after: Optional[Callable[[int], float]] = None
                    ) -> Callable[[int], float]:
    """Linear-scaling warmup: ``schedule(count)`` ramps ``base_lr`` →
    ``base_lr * world_size`` over ``warmup_steps`` updates, then gives
    ``after(count - warmup_steps)`` (default: the scaled rate). The
    boundary update belongs to ``after``: ``count == warmup_steps`` gives
    ``after(0)``. ``warmup_steps=0`` means no warmup: ``after(count)``
    from update 0, or the scaled rate. The JAX package's optax schedule,
    as a plain function of the update count (see :func:`set_lr`)."""
    scaled = base_lr * world_size

    def schedule(count: int) -> float:
        if warmup_steps <= 0:
            return scaled if after is None else after(count)
        if count >= warmup_steps and after is not None:
            return after(count - warmup_steps)
        frac = min(count / warmup_steps, 1.0)
        return base_lr + (scaled - base_lr) * frac

    return schedule


def set_lr(optimizer: torch.optim.Optimizer,
           schedule: Callable[[int], float], count: int) -> None:
    """Set every parameter group's ``lr`` to ``schedule(count)`` before
    update ``count`` (0, 1, …): the rate an optax schedule gives that
    update, whose ``count`` is the number of updates made before it."""
    lr = float(schedule(count))
    for group in optimizer.param_groups:
        group["lr"] = lr
