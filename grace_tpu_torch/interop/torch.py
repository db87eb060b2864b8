"""PyTorch front end: ``DistributedOptimizer`` over the GRACE pipeline.

Counterpart of the JAX package's ``interop/torch.py``, with its API: the
reference's patched Horovod optimizer (a dynamic subclass of the user's
optimizer, ``named_parameters`` checks, ``backward_passes_per_step``,
``synchronize``/``skip_synchronize``, the ``zero_grad`` race guard).

Parameters are walked in reverse registration order (autograd fires
post-accumulate hooks roughly last layer first) and packed into contiguous
buckets of at most ``bucket_cap_mb`` float32 bytes. The hook that fills a
bucket exchanges it at once, through one
:class:`~grace_tpu_torch.interop.bridge.GraceBridge` a bucket seeded
``seed + bi``, while autograd is still producing earlier layers'
gradients. Buckets always launch in bucket order (a filled bucket waits for
its predecessors), so every rank issues the collectives in one order.
``synchronize()`` launches what is left and writes the aggregated
gradients back; ``bucket_cap_mb=None`` makes one bucket, launched at the
last hook.

Where the JAX package copies each bucket to the host and back, the
gradients here never leave their device: a bucket is a ``torch.cat`` of
its gradients and the result is copied into each ``p.grad`` in place.

``broadcast_parameters`` and ``broadcast_optimizer_state`` send rank
``root_rank``'s values to the group with ``torch.distributed.broadcast``;
in a single process they do nothing.
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from typing import Any, Optional

import torch
import torch.distributed as dist

from grace_tpu_torch.interop.bridge import GraceBridge

__all__ = ["DistributedOptimizer", "broadcast_parameters",
           "broadcast_optimizer_state"]


def _find_duplicates(names):
    seen, dups = set(), set()
    for n in names:
        if n in seen:
            dups.add(n)
        seen.add(n)
    return dups


class _DistributedOptimizer:
    """Mixin injected over the user's optimizer class (a dynamic
    subclass, the reference factory's trick)."""

    def _grace_init(self, named_parameters, grace, group, seed,
                    backward_passes_per_step, bucket_cap_mb):
        if named_parameters is not None:
            named_parameters = list(named_parameters)
        else:
            named_parameters = [(f"grace.noname.{i}", v)
                                for param_group in self.param_groups
                                for i, v in enumerate(param_group["params"])]
        if any(not isinstance(p, tuple) for p in named_parameters):
            raise ValueError("named_parameters should be a sequence of "
                             "tuples (name, parameter), usually produced by "
                             "model.named_parameters().")
        dups = _find_duplicates(k for k, _ in named_parameters)
        if dups:
            raise ValueError("Parameter names in named_parameters must be "
                             "unique. Found duplicates: %s"
                             % ", ".join(sorted(dups)))
        all_ids = {id(v) for g in self.param_groups for v in g["params"]}
        named_ids = {id(v) for _, v in named_parameters}
        if all_ids - named_ids:
            raise ValueError("named_parameters was specified, but one or "
                             "more model parameters were not named.")

        # Reverse registration order: buckets fill contiguously as autograd
        # fires hooks last layer first, and registration order is the same
        # on every process.
        self._grace_params = [p for _, p in reversed(named_parameters)
                              if p.requires_grad]
        cap = (float("inf") if not bucket_cap_mb
               else float(bucket_cap_mb) * 2**20)
        buckets, cur, cur_bytes = [], [], 0
        for p in self._grace_params:
            if cur and cur_bytes + p.numel() * 4 > cap:
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(p)
            cur_bytes += p.numel() * 4
        if cur:
            buckets.append(cur)
        self._buckets = buckets
        self._bucket_of = {id(p): bi for bi, b in enumerate(buckets)
                           for p in b}
        # seed + bi: a stream a bucket, the same on every rank.
        self._bridges = [
            GraceBridge(grace, n=sum(p.numel() for p in b), group=group,
                        seed=seed + bi, device=b[0].device)
            for bi, b in enumerate(buckets)]

        self.backward_passes_per_step = backward_passes_per_step
        self._delay = {id(p): backward_passes_per_step
                       for p in self._grace_params}
        self._bucket_left = [len(b) for b in buckets]
        self._pending_b = [None] * len(buckets)
        self._next_launch = 0
        self._synchronized = False
        self._should_synchronize = True
        self._hook_handles = [
            p.register_post_accumulate_grad_hook(self._make_hook())
            for p in self._grace_params]

    # -- backward-path machinery -------------------------------------------
    @property
    def _pending(self):
        """The launched buckets' aggregated gradients, or None if none."""
        live = [p for p in self._pending_b if p is not None]
        return live or None

    def _make_hook(self):
        def hook(p):
            if self._delay[id(p)] <= 0:
                raise AssertionError(
                    "Gradients were computed more than "
                    "backward_passes_per_step times before call to step(). "
                    "Increase backward_passes_per_step to accumulate "
                    "gradients locally.")
            self._delay[id(p)] -= 1
            if self._delay[id(p)] == 0:
                bi = self._bucket_of[id(p)]
                self._bucket_left[bi] -= 1
                if self._bucket_left[bi] == 0:
                    self._launch_ready()
        return hook

    def _flat_grads(self, bi: int) -> torch.Tensor:
        return torch.cat([
            (p.grad if p.grad is not None
             else torch.zeros_like(p)).detach().reshape(-1).to(torch.float32)
            for p in self._buckets[bi]])

    def _launch_ready(self):
        """Exchange every full bucket not yet launched, strictly in bucket
        order: a filled bucket waits for its predecessors, so the
        collective sequence is the same on every rank whatever order
        autograd's hooks fire in."""
        while (self._next_launch < len(self._buckets)
               and self._bucket_left[self._next_launch] == 0):
            bi = self._next_launch
            self._pending_b[bi] = self._bridges[bi].exchange(
                self._flat_grads(bi))
            self._next_launch += 1

    def synchronize(self):
        """Exchange the buckets not yet launched and write every
        aggregated gradient back into ``p.grad``, in place."""
        for bi in range(len(self._buckets)):
            if self._pending_b[bi] is None:   # manual use w/o full backward
                self._pending_b[bi] = self._bridges[bi].exchange(
                    self._flat_grads(bi))
        with torch.no_grad():
            for bi, bucket in enumerate(self._buckets):
                out = self._pending_b[bi]
                self._pending_b[bi] = None
                off = 0
                for p in bucket:
                    size = p.numel()
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    p.grad.copy_(out[off:off + size].view(p.shape))
                    off += size
        self._delay = {id(p): self.backward_passes_per_step
                       for p in self._grace_params}
        self._bucket_left = [len(b) for b in self._buckets]
        self._next_launch = 0
        self._synchronized = True

    def set_backward_passes_per_step(self, passes: int):
        if self._pending is not None or any(
                d != self.backward_passes_per_step
                for d in self._delay.values()):
            # Resetting the counters here would let the next backward
            # launch over the in-flight buckets, dropping their aggregates
            # and advancing the residuals twice.
            raise AssertionError(
                "set_backward_passes_per_step() called with gradients in "
                "flight; call synchronize() or step() first.")
        self.backward_passes_per_step = passes
        self._delay = {k: passes for k in self._delay}
        self._bucket_left = [len(b) for b in self._buckets]
        self._next_launch = 0

    @contextmanager
    def skip_synchronize(self):
        """Use after a manual ``synchronize()`` so that ``step()`` does not
        run it again (the reference's protocol)."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    # -- optimizer protocol -------------------------------------------------
    def step(self, closure=None):
        if self._should_synchronize:
            if self._synchronized:
                warnings.warn(
                    "optimizer.step() called without "
                    "optimizer.skip_synchronize() context after "
                    "optimizer.synchronize(). This can cause training "
                    "slowdown. Consider the skip_synchronize() context.")
            self.synchronize()
        self._synchronized = False
        return super().step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._pending is not None or any(
                d != self.backward_passes_per_step
                for d in self._delay.values()):
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step() or optimizer.synchronize(). This is "
                "prohibited as it can cause a race condition.")
        return super().zero_grad(*args, **kwargs)

    @property
    def grace_state(self):
        """The compression state, one entry a bucket: put it in
        checkpoints."""
        return tuple(b.state for b in self._bridges)

    @grace_state.setter
    def grace_state(self, value):
        if len(self._bridges) == 1 and not isinstance(value, (tuple, list)):
            value = (value,)
        if len(value) != len(self._bridges):
            raise ValueError(f"grace_state has {len(value)} entries for "
                             f"{len(self._bridges)} buckets")
        for b, v in zip(self._bridges, value):
            b.state = v


def DistributedOptimizer(optimizer, grace, named_parameters=None,
                         backward_passes_per_step: int = 1,
                         group: Optional[Any] = None, seed: int = 0,
                         bucket_cap_mb: Optional[float] = 32.0):
    """Wrap a ``torch.optim.Optimizer`` with the compressed exchange of its
    gradients over ``grace``'s communicator.

    Drop-in for the reference's ``hvd.DistributedOptimizer(opt, grace,
    ...)``: the user's optimizer class is subclassed dynamically so that
    isinstance checks and attributes keep working, and the instance is
    rebound. ``group`` is the process group whose rank feeds
    ``GraceBridge.exchange_global`` (None: the communicator's);
    ``bucket_cap_mb`` sets the buckets (module docstring)."""
    cls = type(optimizer.__class__.__name__, (_DistributedOptimizer,
                                              optimizer.__class__), {})
    optimizer.__class__ = cls
    optimizer._grace_init(named_parameters, grace, group, seed,
                          backward_passes_per_step, bucket_cap_mb)
    return optimizer


# -- state synchronisation at start ------------------------------------------

def _world(group) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _src(group, root_rank: int) -> int:
    return root_rank if group is None else dist.get_global_rank(group,
                                                                 root_rank)


def _comm_device(group) -> torch.device:
    """Where a scalar travels: the card under NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_parameters(params, root_rank: int = 0,
                         group: Optional[Any] = None) -> None:
    """Broadcast ``model.state_dict()`` (or a ``(name, tensor)`` iterable)
    from ``root_rank`` to every rank of ``group``, in place."""
    if _world(group) == 1:
        return
    items = sorted(params.items()) if isinstance(params, dict) \
        else sorted(params)
    with torch.no_grad():
        for _, t in items:
            if isinstance(t, torch.Tensor):
                dist.broadcast(t, src=_src(group, root_rank), group=group)


def broadcast_optimizer_state(optimizer, root_rank: int = 0,
                              group: Optional[Any] = None) -> None:
    """Broadcast the optimizer's state, its scalar hyperparameters
    included, from ``root_rank``. Scalars travel as 0-d tensors and come
    back as their Python types."""
    if _world(group) == 1:
        return
    src = _src(group, root_rank)
    dev = _comm_device(group)

    def sync(v):
        if isinstance(v, torch.Tensor):
            # NCCL moves device tensors only (Adam keeps its step count on
            # the CPU).
            out = v.detach().to(dev if dev.type == "cuda" else v.device,
                                copy=True)
            dist.broadcast(out, src=src, group=group)
            return out.to(v.device)
        if isinstance(v, bool):
            t = torch.tensor(int(v), dtype=torch.int64, device=dev)
            dist.broadcast(t, src=src, group=group)
            return bool(t.item())
        if isinstance(v, (int, float)):
            t = torch.tensor(v, dtype=torch.float64 if isinstance(v, float)
                             else torch.int64, device=dev)
            dist.broadcast(t, src=src, group=group)
            return type(v)(t.item())
        if isinstance(v, dict):
            return {k: sync(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(sync(x) for x in v)
        return v       # str, None: taken as the same on every rank

    optimizer.load_state_dict(sync(optimizer.state_dict()))
