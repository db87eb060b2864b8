"""Host data for the examples: the MNIST idx reader, the bundled
8,000/2,000 split, the CIFAR-10 binary reader, the UCI digits, the
normalisation, the shuffled minibatch iterator, the epoch loaders and the
prefetch to the card.

Counterpart of the JAX package's ``data/__init__.py`` (``MemoryDataset``,
``_read_idx``, ``mnist_dataset``, ``mnist_split_dataset``,
``digits_dataset``, ``cifar10_dataset``, ``NativeLoader``, ``PythonLoader``,
``make_loader``, ``prefetch_to_device``) and of the example helpers
``batches``, ``load_mnist_idx``, ``load_mnist_auto`` and
``load_cifar10_binary`` in ``examples/common.py``, which the port cannot
import (they import the JAX package). The datasets and ``PythonLoader`` are
numpy, so both packages see the same arrays bit for bit.

``NativeLoader`` binds ``csrc/dataloader.cpp`` with ctypes: worker threads
assemble normalised float32 batches into a bounded ring while the card runs
the previous step. The library is built with the host C++ compiler at the
first use (``ops._build.host_library``)::

    loader = make_loader(MemoryDataset(x_uint8, y, mean, std), batch_size=512,
                         seed=0)              # rank, world: the process group's
    for epoch in range(E):
        for x, y in prefetch_to_device(loader.epoch(epoch), "cuda"):
            ...                               # x: (B,H,W,C) f32, y: (B,) i32

An epoch's order is a pure function of (seed, epoch), the same on every
rank; rank r takes the strided slice r::world of each epoch's permutation.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import gzip
import logging
import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = ["MemoryDataset", "mnist_dataset", "mnist_split_dataset",
           "split_indices", "load_mnist_idx", "load_mnist_auto", "batches",
           "cifar10_dataset", "load_cifar10_binary", "BUNDLED_MNIST_DIR",
           "digits_dataset", "NativeLoader", "PythonLoader", "make_loader",
           "prefetch_to_device"]

_log = logging.getLogger(__name__)

# The public-domain MNIST t10k files the repository bundles.
BUNDLED_MNIST_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "examples", "data", "MNIST", "raw")

MNIST_MEAN, MNIST_STD = (0.1307,), (0.3081,)


@dataclasses.dataclass(frozen=True)
class MemoryDataset:
    """In-memory uint8 NHWC images, int32 labels and per-channel
    normalisation stats in [0, 1] units (multiplied by 255 internally)."""

    images: np.ndarray          # (n, h, w, c) uint8
    labels: np.ndarray          # (n,) int32
    mean: Optional[Tuple[float, ...]] = None
    std: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.images.dtype != np.uint8 or self.images.ndim != 4:
            raise ValueError("images must be (n,h,w,c) uint8")
        if len(self.labels) != len(self.images):
            raise ValueError("labels/images length mismatch")

    def normalize(self, raw: np.ndarray) -> np.ndarray:
        """``raw`` uint8 images → float32, ``(x − 255·mean) / (255·std)``
        (or ``x / 255`` without stats), computed in float32."""
        x = raw.astype(np.float32)
        if self.mean is None:
            return x / 255.0
        mean = np.asarray(self.mean, np.float32) * 255.0
        std = np.asarray(self.std, np.float32) * 255.0
        return (x - mean) / std


def _open_idx(data_dir: str, name: str):
    for cand in (os.path.join(data_dir, name),
                 os.path.join(data_dir, name + ".gz")):
        if os.path.exists(cand):
            return gzip.open(cand, "rb") if cand.endswith(".gz") \
                else open(cand, "rb")
    raise FileNotFoundError(f"{name}[.gz] not found under {data_dir}")


def _read_idx(data_dir: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """The MNIST idx(.gz) pair of ``data_dir``: ``(n, 28, 28, 1)`` uint8
    images and ``(n,)`` int32 labels; ``train`` picks ``train-*`` over
    ``t10k-*``."""
    prefix = "train" if train else "t10k"
    with _open_idx(data_dir, f"{prefix}-images-idx3-ubyte") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad idx magic {magic}")
        x = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols, 1)
    with _open_idx(data_dir, f"{prefix}-labels-idx1-ubyte") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad idx magic {magic}")
        y = np.frombuffer(f.read(), np.uint8).astype(np.int32)
    return x, y


def mnist_dataset(data_dir: str, train: bool = True) -> MemoryDataset:
    """MNIST idx(.gz) files → MemoryDataset with the standard stats."""
    x, y = _read_idx(data_dir, train)
    return MemoryDataset(x, y, mean=MNIST_MEAN, std=MNIST_STD)


def split_indices(n: int, train: bool, split_seed: int = 0,
                  fraction: float = 0.8) -> np.ndarray:
    """The sorted rows of one side of the fixed-seed split of ``n``
    images: ``default_rng(split_seed).permutation(n)``, the first
    ``int(fraction·n)`` for training, the rest for test."""
    idx = np.random.default_rng(split_seed).permutation(n)
    cut = int(fraction * n)
    return np.sort(idx[:cut] if train else idx[cut:])


def mnist_split_dataset(data_dir: str, train: bool = True,
                        split_seed: int = 0,
                        fraction: float = 0.8) -> MemoryDataset:
    """The deterministic 8,000/2,000 split of the MNIST *t10k* files (the
    bundled set): disjoint by construction, the same for a given
    ``split_seed``."""
    x, y = _read_idx(data_dir, train=False)
    sel = split_indices(len(x), train, split_seed, fraction)
    return MemoryDataset(x[sel], y[sel], mean=MNIST_MEAN, std=MNIST_STD)


def digits_dataset(train: bool = True, upscale: bool = True,
                   split_seed: int = 0) -> MemoryDataset:
    """The UCI handwritten digits that scikit-learn bundles: 1,797 scanned
    8×8 digits, a fixed-seed 80/20 split (disjoint, the same for a given
    ``split_seed``). ``upscale`` repeats each pixel 3×3 and pads to 28×28,
    so LeNet applies unchanged. The statistics are the train split's, for
    both splits."""
    try:
        from sklearn.datasets import load_digits
    except ImportError as e:
        raise ImportError(
            "digits_dataset needs scikit-learn (the dataset is bundled with "
            "it): pip install scikit-learn") from e

    d = load_digits()
    x = np.round(d.images / 16.0 * 255.0).astype(np.uint8)[..., None]
    y = d.target.astype(np.int32)
    if upscale:
        x = np.kron(x[..., 0], np.ones((3, 3), np.uint8))[..., None]
        x = np.pad(x, ((0, 0), (2, 2), (2, 2), (0, 0)))
    order = np.random.default_rng(split_seed).permutation(len(x))
    n_train = int(0.8 * len(x))
    sel = order[:n_train] if train else order[n_train:]
    ref = x[order[:n_train]].astype(np.float32) / 255.0
    return MemoryDataset(x[sel], y[sel],
                         mean=(float(ref.mean()),), std=(float(ref.std()),))


CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2471, 0.2435, 0.2616)


def _read_cifar10(data_dir: str, train: bool
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 binary batches (``data_batch_{1..5}.bin`` or
    ``test_batch.bin``; 3073-byte records, a label then CHW pixels) →
    ``(n, 32, 32, 3)`` uint8 NHWC images and int32 labels."""
    names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
             else ["test_batch.bin"])
    xs, ys = [], []
    for name in names:
        raw = np.fromfile(os.path.join(data_dir, name), np.uint8)
        raw = raw.reshape(-1, 3073)
        ys.append(raw[:, 0].astype(np.int32))
        xs.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
    return np.concatenate(xs), np.concatenate(ys)


def cifar10_dataset(data_dir: str, train: bool = True) -> MemoryDataset:
    """CIFAR-10 binary batches → MemoryDataset with the standard stats."""
    x, y = _read_cifar10(data_dir, train)
    return MemoryDataset(x, y, mean=CIFAR10_MEAN, std=CIFAR10_STD)


def load_cifar10_binary(data_dir: str, train: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 binary batches, normalised ``(x/255 − mean) / std`` in
    float32 (the example helper's arithmetic)."""
    x, y = _read_cifar10(data_dir, train)
    x = x.astype(np.float32) / 255.0
    mean = np.array(CIFAR10_MEAN, np.float32)
    std = np.array(CIFAR10_STD, np.float32)
    return (x - mean) / std, y


def load_mnist_idx(data_dir: str, train: bool = True
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The full MNIST idx pair, normalised ``(x/255 − 0.1307) / 0.3081``."""
    x, y = _read_idx(data_dir, train)
    x = (x.astype(np.float32) / 255.0 - 0.1307) / 0.3081
    return x, y


def load_mnist_auto(data_dir: str, split_seed: int = 0):
    """``(x_train, y_train, x_test, y_test)``, normalised, from whatever
    MNIST files ``data_dir`` holds: the full train/t10k pair when present,
    else the 8,000/2,000 split of the t10k set. The split's test images are
    normalised with the train split's statistics."""
    has_full = any(
        os.path.exists(os.path.join(data_dir, "train-images-idx3-ubyte" + s))
        for s in ("", ".gz"))
    if has_full:
        return (*load_mnist_idx(data_dir, train=True),
                *load_mnist_idx(data_dir, train=False))
    tr = mnist_split_dataset(data_dir, train=True, split_seed=split_seed)
    te = mnist_split_dataset(data_dir, train=False, split_seed=split_seed)
    return (tr.normalize(tr.images), tr.labels,
            tr.normalize(te.images), te.labels)


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, *, shuffle: bool,
            seed: int, drop_last: bool = True
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Minibatches over host arrays, shuffled by ``default_rng(seed)``."""
    n = x.shape[0]
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    stop = n - (n % batch_size) if drop_last else n
    for i in range(0, stop, batch_size):
        sel = idx[i:i + batch_size]
        yield x[sel], y[sel]


# -- the epoch loaders --------------------------------------------------------

def _rank_world(rank: Optional[int], world: Optional[int]) -> Tuple[int, int]:
    """``rank`` and ``world``, each defaulting to the default process
    group's (0 and 1 outside one)."""
    grouped = torch.distributed.is_available() and \
        torch.distributed.is_initialized()
    if rank is None:
        rank = torch.distributed.get_rank() if grouped else 0
    if world is None:
        world = torch.distributed.get_world_size() if grouped else 1
    return rank, world


class _LoaderBase:
    """The contract of both loaders. ``epoch(e)`` yields ``(x, y)``: ``(B,
    H, W, C)`` float32 normalised images and ``(B,)`` int32 labels, in the
    order of epoch ``e``'s permutation, a pure function of ``(seed, e)``,
    this rank's strided share ``r::world``.

    With ``drop_last=False`` the short final batch wraps to its own front,
    so every batch has one shape. That counts those samples twice: for an
    exact evaluation metric, truncate to a batch multiple or weight the last
    batch by its true count. ``kind`` names the implementation."""

    kind: str
    batch_size: int
    shape: Tuple[int, int, int]

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        raise NotImplementedError


@functools.cache
def _native_lib() -> ctypes.CDLL:
    from grace_tpu_torch.ops import _build
    lib = _build.host_library("dataloader")
    lib.gl_open_memory.restype = ctypes.c_void_p
    lib.gl_open_memory.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int64, ctypes.c_int64]
    lib.gl_start_epoch.restype = ctypes.c_int64
    lib.gl_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int64]
    lib.gl_next.restype = ctypes.c_int
    lib.gl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p]
    lib.gl_close.restype = None
    lib.gl_close.argtypes = [ctypes.c_void_p]
    lib.gl_last_error.restype = ctypes.c_char_p
    return lib


class NativeLoader(_LoaderBase):
    """The threaded loader of ``csrc/dataloader.cpp``: ``n_threads``
    workers fill a ring of ``queue_depth`` batches ahead of the caller. It
    shuffles with ``std::mt19937_64``, so its order is not
    ``PythonLoader``'s. Raises ``RuntimeError`` when the library cannot be
    built or refuses the dataset."""

    kind = "native"

    def __init__(self, dataset: MemoryDataset, batch_size: int, *,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 rank: Optional[int] = None, world: Optional[int] = None,
                 n_threads: int = 4, queue_depth: int = 4):
        lib = _native_lib()
        rank, world = _rank_world(rank, world)
        imgs = np.ascontiguousarray(dataset.images)
        labs = np.ascontiguousarray(dataset.labels.astype(np.int32))
        n, h, w, c = imgs.shape
        mean = std = None
        if dataset.mean is not None:
            mean = np.zeros(3, np.float32)
            std = np.ones(3, np.float32)
            mean[:c] = np.asarray(dataset.mean, np.float32)
            std[:c] = np.asarray(dataset.std, np.float32)
        # The library copies the dataset: the arrays may go after this call.
        self._handle = lib.gl_open_memory(
            imgs.ctypes.data, labs.ctypes.data, n, h, w, c,
            None if mean is None else mean.ctypes.data,
            None if std is None else std.ctypes.data,
            batch_size, int(shuffle), int(drop_last), seed % 2**64, rank,
            world)
        if not self._handle:
            raise RuntimeError(lib.gl_last_error().decode())
        self._lib = lib
        self.batch_size = batch_size
        self.shape = (h, w, c)
        self._n_threads = n_threads
        self._queue_depth = queue_depth

    def epoch(self, epoch: int):
        h, w, c = self.shape
        n_batches = self._lib.gl_start_epoch(self._handle, epoch,
                                             self._n_threads,
                                             self._queue_depth)
        for _ in range(n_batches):
            x = np.empty((self.batch_size, h, w, c), np.float32)
            y = np.empty((self.batch_size,), np.int32)
            if self._lib.gl_next(self._handle, x.ctypes.data,
                                 y.ctypes.data) != 1:
                raise RuntimeError("native loader stopped mid-epoch")
            yield x, y

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.gl_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PythonLoader(_LoaderBase):
    """The same contract in numpy: Fisher-Yates through
    ``default_rng(seed·0x9E3779B97F4A7C15 + epoch mod 2^63)``, so
    deterministic and rank-disjoint as the native loader, with another
    order."""

    kind = "python"

    def __init__(self, dataset: MemoryDataset, batch_size: int, *,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 rank: Optional[int] = None, world: Optional[int] = None,
                 **_ignored):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.rank, self.world = _rank_world(rank, world)
        self.shape = tuple(dataset.images.shape[1:])

    def epoch(self, epoch: int):
        perm = np.arange(len(self.ds.images))
        if self.shuffle:
            np.random.default_rng(
                (self.seed * 0x9E3779B97F4A7C15 + epoch) % 2**63
            ).shuffle(perm)
        order = perm[self.rank::self.world]
        b = self.batch_size
        stop = len(order) - (len(order) % b) if self.drop_last else len(order)
        for i in range(0, stop, b):
            count = min(b, len(order) - i)
            sel = order[i + (np.arange(b) % count)]
            yield (self.ds.normalize(self.ds.images[sel]),
                   self.ds.labels[sel].astype(np.int32))


def make_loader(dataset: MemoryDataset, batch_size: int,
                **kwargs) -> _LoaderBase:
    """``NativeLoader``, or ``PythonLoader`` where the native library
    cannot be built or loaded; the reason is logged as a warning, and the
    loader's ``kind`` says which one it is."""
    try:
        return NativeLoader(dataset, batch_size, **kwargs)
    except (OSError, RuntimeError) as e:
        _log.warning("make_loader: the native loader is unavailable (%s); "
                     "using PythonLoader", e)
    return PythonLoader(dataset, batch_size, **kwargs)


# -- the prefetch to the card -------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def prefetch_to_device(iterator, device=None, size: int = 2):
    """Device-side double buffering over a host batch iterator: each batch
    (a tuple, list or dict of numpy arrays or CPU tensors) is staged in
    pinned memory and copied to ``device`` with ``non_blocking=True`` on a
    side CUDA stream, ``size`` batches ahead of the one the caller holds,
    so the copies overlap the steps. The caller's stream waits on each
    batch's copy before it is yielded, and ``record_stream`` keeps the
    allocator from handing its memory to the side stream while the
    caller's stream still reads it.

    On ``device="cpu"`` it yields the same batches as tensors
    (``torch.as_tensor``, sharing the arrays' memory) in the same order,
    with no stream work. Validation is eager: a missing device or ``size <
    1`` raises here, not at the first pull."""
    from grace_tpu_torch.parallel import resolve_device

    if device is None:
        raise ValueError("prefetch_to_device needs a device")
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return _prefetch_gen(iterator, lambda b: (_tree_map(
            torch.as_tensor, b), None), size)
    return _prefetch_gen(iterator, _CudaStager(dev), size)


class _CudaStager:
    """One batch: host → pinned → (side stream) → the card. Returns the
    device batch and the hand-over that makes the caller's stream wait for
    its copies. The pinned buffers stay referenced until the hand-over (the
    caching host allocator also holds them until their copies end)."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.stream = torch.cuda.Stream(device=dev)

    def __call__(self, batch):
        pinned = []

        def stage(leaf):
            host = torch.as_tensor(leaf)
            if host.device.type == "cuda":
                return host
            buf = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            buf.copy_(host)
            pinned.append(buf)
            with torch.cuda.stream(self.stream):
                return buf.to(self.dev, non_blocking=True)

        out = _tree_map(stage, batch)
        done = torch.cuda.Event()
        done.record(self.stream)

        def hand_over():
            consumer = torch.cuda.current_stream(self.dev)
            consumer.wait_event(done)
            for t in _leaves(out):
                if t.device.type == "cuda":
                    t.record_stream(consumer)
            pinned.clear()

        return out, hand_over


def _prefetch_gen(iterator, stage, size: int):
    queue = collections.deque()
    it = iter(iterator)

    def _put_next() -> bool:
        try:
            batch = next(it)
        except StopIteration:
            return False
        queue.append(stage(batch))
        return True

    for _ in range(size):
        if not _put_next():
            break
    while queue:
        out, hand_over = queue.popleft()
        if hand_over is not None:
            hand_over()
        _put_next()
        yield out
