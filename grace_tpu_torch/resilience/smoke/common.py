"""What the drills share: the output paths, the rank-aware printer, the
record tape, the models and their seeded data, and the chaos wrappers."""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable, List

import numpy as np
import torch
import torch.distributed as dist

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PREFIX = "[chaos_smoke]"


def default_path(name: str) -> str:
    """``grace_tpu_torch/<name>``: where a drill's output lands unless a
    flag names another place (the repository root's files are the JAX
    package's)."""
    return os.path.join(PKG_DIR, name)


def rank_of(group=None) -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group)
    return 0


def world_of(group=None) -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def say(msg: str) -> None:
    """A progress line, from the first rank only."""
    if rank_of() == 0:
        print(f"{PREFIX} {msg}", flush=True)


def fail(msg: str) -> int:
    """A failed acceptance fact: printed to stderr by the first rank (and by
    any other rank that alone reaches it, tagged with its rank); returns
    the exit code 1."""
    r = rank_of()
    tag = "" if r == 0 else f" (rank {r})"
    print(f"{PREFIX} FAIL{tag}: {msg}", file=sys.stderr, flush=True)
    return 1


class Tape:
    """A sink that keeps every record in a list, on every rank (the JSONL
    artifact is written by the first rank only): the drills judge event
    orders and read rows from it."""

    def __init__(self):
        self.records: List[dict] = []

    def write(self, rec) -> None:
        self.records.append(dict(rec))

    def close(self) -> None:
        pass


def in_child(target, args: tuple, group=None, timeout: float = 600.0,
             preload=()):
    """``target(conn, *args)`` in a process of its own (forked from the
    ``multiprocessing`` fork server: no process group, no card context of
    this one's), run by the group's first rank; what it sends, on every
    rank (a broadcast over the group), or None when it gave nothing within
    ``timeout`` seconds."""
    import multiprocessing

    result = None
    if rank_of(group) == 0:
        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload(list(preload))
        recv, send = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=target, args=(send,) + tuple(args),
                           daemon=True)
        proc.start()
        send.close()
        try:
            if recv.poll(timeout):
                try:
                    result = recv.recv()
                except EOFError:
                    result = None
        finally:
            recv.close()
            if proc.is_alive():
                proc.kill()
            proc.join()
    if world_of(group) > 1:
        box = [result]
        dist.broadcast_object_list(box, src=dist.get_global_rank(
            group, 0) if group is not None else 0, group=group)
        result = box[0]
    return result


def shared_dir(path: str, prefix: str, group=None) -> str:
    """``path``, or a fresh temporary directory made by the group's first
    rank and named to every rank (a checkpoint's ranks share one)."""
    if path:
        return path
    import tempfile
    box = [tempfile.mkdtemp(prefix=prefix) if rank_of(group) == 0
           else None]
    if world_of(group) > 1:
        dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def wrap_codec(grace, wrap: Callable):
    """``grace`` with its compressor and every rung of its adaptive ladder
    wrapped by ``wrap`` (a fault that afflicted only the top rung would
    vanish the moment the controller moved)."""
    grace = dataclasses.replace(grace, compressor=wrap(grace.compressor))
    if grace.adapt is not None:
        grace = dataclasses.replace(grace, adapt=dataclasses.replace(
            grace.adapt, ladder=tuple(wrap(c) for c in grace.adapt.ladder)))
    return grace


def rows(global_batch: int, rank: int, world: int, lo: int) -> slice:
    """This rank's rows of the global batch that starts at ``lo``: the
    JAX package shards a batch over the mesh's data axis in rank order."""
    per = global_batch // world
    return slice(lo + rank * per, lo + (rank + 1) * per)


# -- LeNet on MNIST-shaped synthetic data ------------------------------------------

def lenet(seed: int, device):
    """LeNet with the JAX package's initial weights for ``seed``."""
    from grace_tpu_torch.models.lenet import LeNet
    return LeNet(device=device, seed=seed)


def lenet_loss(model, batch) -> torch.Tensor:
    x, y = batch
    return torch.nn.functional.cross_entropy(model(x), y)


def lenet_data(n: int, seed: int):
    """``n`` random 28×28×1 images and labels, as the JAX drill draws
    them."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, size=(n,)).astype(np.int32)
    return images, labels


def batch_at(images, labels, global_batch: int, i: int, group, device,
             clamp: bool = True):
    """Step ``i``'s global batch (the JAX drill's window over the data) cut
    to this rank's rows, on ``device``: the window at ``(i · batch) mod
    (n − batch + 1)``, which never runs off the end, or with
    ``clamp=False`` at ``(i · batch) mod n`` (the default run's)."""
    n = len(images)
    lo = ((i * global_batch) % (n - global_batch + 1) if clamp
          else (i * global_batch) % n)
    part = rows(global_batch, rank_of(group), world_of(group), lo)
    return (torch.from_numpy(images[part]).to(device),
            torch.from_numpy(labels[part].astype(np.int64)).to(device))


# -- the toy MLP of the adapt, retune and fsdp drills ------------------------------

FEAT, HID, CLASSES = 32, 16, 8


def mlp_params(rng) -> dict:
    """The JAX drill's draws, in its order."""
    return {"w1": rng.normal(scale=0.3, size=(FEAT, HID)).astype(np.float32),
            "b1": np.zeros((HID,), np.float32),
            "w2": rng.normal(scale=0.3, size=(HID, CLASSES)).astype(
                np.float32),
            "b2": np.zeros((CLASSES,), np.float32)}


def mlp(params: dict, device):
    return torch.nn.ParameterDict(
        {n: torch.nn.Parameter(torch.from_numpy(a.copy()).to(device))
         for n, a in params.items()})


def mlp_loss(model, batch) -> torch.Tensor:
    x, y = batch
    h = torch.tanh(x @ model["w1"] + model["b1"])
    return torch.nn.functional.cross_entropy(h @ model["w2"] + model["b2"],
                                             y)


def mlp_data(rng, global_batch: int):
    images = rng.normal(size=(4 * global_batch, FEAT)).astype(np.float32)
    labels = rng.integers(0, CLASSES, size=(4 * global_batch,)).astype(
        np.int32)
    return images, labels


def world_batch(batch: int, world: int) -> int:
    """The global batch rounded to whole rank shares, at least one each."""
    return max(batch, world) // world * world


def finite(x) -> bool:
    return bool(np.isfinite(float(x)))
