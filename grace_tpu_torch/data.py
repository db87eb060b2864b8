"""Host data for the examples: the MNIST idx reader, the bundled
8,000/2,000 split, the CIFAR-10 binary reader, normalisation and the
shuffled minibatch iterator.

Counterpart of the in-memory half of the JAX package's
``data/__init__.py`` (``MemoryDataset``, ``_read_idx``, ``mnist_dataset``,
``mnist_split_dataset``, ``cifar10_dataset``) and of the example helpers
``batches``, ``load_mnist_idx``, ``load_mnist_auto`` and
``load_cifar10_binary`` in ``examples/common.py``,
which the port cannot import (they import the JAX package). Everything
here is numpy, so both packages see the same arrays bit for bit. The
native threaded loader and device prefetch are queued in ROADMAP.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["MemoryDataset", "mnist_dataset", "mnist_split_dataset",
           "split_indices", "load_mnist_idx", "load_mnist_auto", "batches",
           "cifar10_dataset", "load_cifar10_binary", "BUNDLED_MNIST_DIR"]

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
