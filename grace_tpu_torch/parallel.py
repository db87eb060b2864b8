"""Devices and process groups.

The JAX package runs on a device mesh; this port runs one process per
device in a ``torch.distributed`` process group: NCCL for CUDA devices,
gloo for the CPU. Rendezvous is local only (``file://`` or a loopback
``tcp://`` address). Entry points default to CUDA and raise when it is
missing unless the caller asked for the CPU: nothing moves to the CPU
quietly.

``broadcast_tree`` and ``metric_average`` are the JAX package's
``parallel.broadcast_tree`` and ``parallel.metric_average`` over a process
group: the identity (and ``numpy`` leaves) at one rank, one collective
beyond it.

``make_mesh((dp, fsdp), ("data", "fsdp"))`` is the JAX package's
``make_mesh`` for the 2-D sharded-model track: a ``transform.MeshSpec``
bound to this rank's dp group, fsdp group and the whole mesh. ``psum`` and
``all_gather`` are the differentiable cross-shard collectives a sharded
model's loss calls over ``mesh.fsdp_group``, with JAX's transposes.
"""

from __future__ import annotations

import math
import socket
from typing import Optional
from urllib.parse import urlparse

import numpy as np
import torch
import torch.distributed as dist

from grace_tpu_torch.telemetry import counters

_LOCAL_HOSTS = ("127.0.0.1", "localhost", "::1")


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it is CUDA and there is
    no CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; grace_tpu_torch runs on the GPU by "
                "default. Pass device='cpu' to run the plain versions on "
                "the CPU.")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def _free_loopback_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _check_local(init_method: str) -> None:
    url = urlparse(init_method)
    if url.scheme == "file":
        return
    if url.scheme == "tcp" and url.hostname in _LOCAL_HOSTS:
        return
    raise ValueError(f"init_method {init_method!r} is not local: use "
                     "file://<path> or tcp://127.0.0.1:<port>")


def init_process_group(device="cuda", *, rank: int = 0, world_size: int = 1,
                       init_method: Optional[str] = None):
    """Join (or, at world size 1, form) the default process group for
    ``device``: NCCL on CUDA (binding this process to that card), gloo on
    the CPU. ``init_method`` is required beyond one rank; one rank picks a
    free loopback port itself. Returns ``(group, device)``."""
    dev = resolve_device(device)
    if init_method is None:
        if world_size != 1:
            raise ValueError("a multi-rank group needs an explicit local "
                             "init_method (file://<path> or "
                             "tcp://127.0.0.1:<port>)")
        init_method = f"tcp://127.0.0.1:{_free_loopback_port()}"
    _check_local(init_method)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world_size)
    return dist.group.WORLD, dev


def _world(group) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def make_mesh(shape, axis_names=("data", "fsdp"), group=None):
    """The 2-D (or 1-D) process-group mesh over ``group`` (None: the
    default group): a bound :class:`~grace_tpu_torch.transform.MeshSpec`.

    ``shape`` is ``(dp,)`` or ``(dp, fsdp)`` with ``dp·fsdp`` the group's
    size, ``axis_names`` the JAX package's axis names. Rank ``r`` of
    ``group`` sits at dp index ``r // fsdp`` and fsdp index ``r % fsdp``,
    the device layout of ``jax.make_mesh((dp, fsdp))``, so rank ``r`` holds
    what JAX's device row ``r`` holds. The spec carries this rank's **dp
    group** (the ranks of its fsdp index: the compressed exchange), its
    **fsdp group** (the ranks of its dp index: the model's cross-shard
    collectives) and the whole mesh (``group``: the guard's verdict).

    Every rank calls ``dist.new_group`` for every subgroup in one order (dp
    groups by fsdp index, then fsdp groups by dp index), with
    ``use_local_synchronization`` as ``comm._hier_groups`` does; a subgroup
    that spans the whole mesh is ``group`` itself, so a 1-wide axis adds no
    communicator. A group ranks its members by ascending global rank, the
    order of the mesh index along the axis. Call it once a mesh: each call
    makes new groups."""
    from grace_tpu_torch.transform import MeshSpec

    shape = tuple(int(n) for n in shape)
    names = tuple(axis_names)[:len(shape)]
    if len(shape) not in (1, 2) or len(names) != len(shape) \
            or min(shape) < 1:
        raise ValueError(f"make_mesh takes (dp,) or (dp, fsdp) with one "
                         f"name an axis; got shape {shape}, axis_names "
                         f"{tuple(axis_names)}")
    world = _world(group)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} has {math.prod(shape)} ranks "
                         f"but the group has {world}")
    dp = shape[0]
    fsdp = shape[1] if len(shape) > 1 else 1
    me = dist.get_rank(group) if world > 1 or dist.is_initialized() else 0

    def global_rank(j):
        return j if group is None else dist.get_global_rank(group, j)

    def subgroup(lists):
        mine = group
        for ranks in lists:
            if len(ranks) == world:
                continue
            pg = dist.new_group([global_rank(j) for j in ranks],
                                use_local_synchronization=True)
            if me in ranks:
                mine = pg
        return mine

    dp_group = subgroup([[d * fsdp + f for d in range(dp)]
                         for f in range(fsdp)])
    fsdp_group = subgroup([[d * fsdp + f for f in range(fsdp)]
                           for d in range(dp)])
    return MeshSpec(dp_axis=names[0],
                    fsdp_axis=names[1] if len(names) > 1 else None,
                    shape=shape, group=group, dp_group=dp_group,
                    fsdp_group=fsdp_group if len(shape) > 1 else None,
                    dp_index=me // fsdp, fsdp_index=me % fsdp)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        counters.count("all_reduce", out)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        counters.count("all_reduce", g)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        from grace_tpu_torch.comm import _all_gather_into

        world = dist.get_world_size(group)
        ctx.group, ctx.dim, ctx.size = group, dim, t.shape[dim]
        ctx.rank = dist.get_rank(group)
        flat = torch.empty(world * t.numel(), dtype=t.dtype, device=t.device)
        counters.count("all_gather", t)
        _all_gather_into(flat, t.contiguous().view(-1), group=group)
        parts = flat.view((world,) + tuple(t.shape))
        return torch.cat(list(parts), dim)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        counters.count("all_reduce", g)
        dist.all_reduce(g, group=ctx.group)
        return (g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size)
                .contiguous(), None, None)


def psum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group``, differentiable: its backward pass
    sums the cotangents over the group, as the JAX package's transpose of
    ``lax.psum`` under ``shard_map(check_vma=False)`` does (so a loss
    replicated over the group gives each rank the group's width times its
    own gradient, JAX's per-shard gradient). The identity at one rank.
    ``loss_fn``'s cross-shard reduce over ``mesh.fsdp_group``."""
    if _world(group) == 1:
        return t
    return _Psum.apply(t, group)


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated on ``dim`` in group-rank order,
    differentiable: JAX's ``lax.all_gather(t, axis, axis=dim,
    tiled=True)``, whose backward pass is the sum of the cotangents over
    the group, this rank's slice of it (JAX's transpose, ``psum_scatter``).
    One flat all-gather forward and one all-reduce backward, so gloo
    subgroups work. The identity at one rank."""
    if _world(group) == 1:
        return t
    return _AllGather.apply(t, group, dim)


def broadcast_tree(tree, root_process: int = 0, group=None):
    """``tree`` (a dict, list or tuple of tensors and host values) with
    every leaf replaced by rank ``root_process``'s: tensor leaves by a
    broadcast of each (on its own device, so a CUDA tensor over NCCL),
    host leaves (numpy arrays, numbers) as one object broadcast. Every rank
    must pass the same structure, shapes and dtypes. The identity at one
    rank. ``root_process`` is a rank of ``group``."""
    from grace_tpu_torch.data import _leaves, _tree_map

    if _world(group) == 1:
        return tree
    src = dist.get_global_rank(group, root_process) if group is not None \
        else root_process
    me = dist.get_rank(group) == root_process
    host = [v for v in _leaves(tree) if not isinstance(v, torch.Tensor)]
    if host:
        box = [host if me else None]
        counters.count("broadcast_object")
        dist.broadcast_object_list(box, src=src, group=group)
        host = iter(box[0])

    def leaf(v):
        if not isinstance(v, torch.Tensor):
            return next(host)
        out = v.detach().clone()
        counters.count("broadcast", *([out] if me else []))
        dist.broadcast(out, src=src, group=group)
        return out

    return _tree_map(leaf, tree)


def metric_average(metrics, group=None):
    """The mean over the ranks of a host metrics tree (numbers, numpy
    arrays or tensors), as numpy, by one all-reduce of all leaves packed in
    float64: the reference's ``metric_average``. A float leaf keeps its
    dtype (the float64 sum rounded once, so within one rounding of the JAX
    package's ``np.mean`` over the gathered values, and equal to it at two
    ranks), an integer or bool leaf comes back float64, as ``np.mean``
    gives. At one rank, every leaf as a numpy array."""
    from grace_tpu_torch.data import _leaves, _tree_map

    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)

    world = _world(group)
    if world == 1:
        return _tree_map(host, metrics)
    leaves = [host(v) for v in _leaves(metrics)]
    dev = torch.device("cpu")
    if dist.get_backend(group) == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    flat = torch.from_numpy(np.concatenate(
        [v.astype(np.float64).ravel() for v in leaves] or
        [np.zeros(0)])).to(dev)
    counters.count("all_reduce", flat)
    dist.all_reduce(flat, group=group)
    mean = (flat / world).cpu().numpy()
    parts, at = iter(leaves), 0

    def out(_):
        nonlocal at
        v = next(parts)
        m = mean[at:at + v.size].reshape(v.shape)
        at += v.size
        return m.astype(v.dtype) if np.issubdtype(v.dtype, np.floating) \
            else m

    return _tree_map(out, metrics)
