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
"""

from __future__ import annotations

import socket
from typing import Optional
from urllib.parse import urlparse

import numpy as np
import torch
import torch.distributed as dist

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
        dist.broadcast_object_list(box, src=src, group=group)
        host = iter(box[0])

    def leaf(v):
        if not isinstance(v, torch.Tensor):
            return next(host)
        out = v.detach().clone()
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
