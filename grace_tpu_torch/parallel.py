"""Devices and process groups.

The JAX package runs on a device mesh; this port runs one process per
device in a ``torch.distributed`` process group: NCCL for CUDA devices,
gloo for the CPU. Rendezvous is local only (``file://`` or a loopback
``tcp://`` address). Entry points default to CUDA and raise when it is
missing unless the caller asked for the CPU: nothing moves to the CPU
quietly.
"""

from __future__ import annotations

import socket
from typing import Optional
from urllib.parse import urlparse

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
