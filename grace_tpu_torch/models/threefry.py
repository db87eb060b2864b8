"""The JAX package's seeded initialisers, drawn in numpy without JAX.

``jax.random`` is counter-based: Threefry-2x32 (20 rounds) hashes a
64-bit counter under a 2×32-bit key. With JAX's default
``jax_threefry_partitionable``, ``split(key, n)[i]`` is the hash of
counter ``i``, and ``random_bits(key, 32, shape)`` is the XOR of the two
output words of the hash of each element's row-major index.
``normal`` maps those bits to a uniform in ``(-1, 1)`` and applies
``√2·erfinv``. This module reproduces the keys and the bits exactly, and
runs XLA's single-precision ``erfinv`` polynomial operation by operation in
float32; XLA may contract its multiply-adds and numpy's ``log1p`` may
round apart from XLA's, so a normal draw lies within a few ulps of JAX's.

So ``LeNet(seed=s)`` starts from the weights of the JAX package's
``lenet.init(jax.random.key(s))``, and the two packages' MNIST runs are
comparable from the first step.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

Key = Tuple[np.uint32, np.uint32]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Key, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter words ``(x0, x1)`` under ``key``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for ``0 <= seed < 2**32`` (32-bit JAX):
    the words ``(0, seed)``."""
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed {seed} is outside [0, 2**32)")
    return np.uint32(0), np.uint32(seed)


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), i.astype(np.uint32)


def split(k: Key, n: int) -> list:
    """``jax.random.split(k, n)``."""
    b0, b1 = threefry2x32(k, *_counters(n))
    return [(b0[i], b1[i]) for i in range(n)]


def random_bits(k: Key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(k, shape, uint32)``."""
    b0, b1 = threefry2x32(k, *_counters(int(np.prod(shape, dtype=np.int64))))
    return (b0 ^ b1).reshape(shape)


def uniform(k: Key, shape: Sequence[int], minval: float, maxval: float
            ) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``."""
    bits = random_bits(k, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


# XLA's ErfInv for float32: a degree-8 polynomial in w = -log1p(-x^2) − 2.5
# (w < 5) or sqrt(w) − 3, times x.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ErfInv, operation by operation in float32."""
    x = x.astype(np.float32)
    w = -np.log1p(-(x * x))
    lt = w < np.float32(5)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(np.maximum(w, np.float32(0))) - np.float32(3))
    coef = [np.where(lt, np.float32(a), np.float32(b))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:       # a fused multiply-add: one rounding
        p = (c.astype(np.float64) + p.astype(np.float64)
             * w.astype(np.float64)).astype(np.float32)
    return p * x


def normal(k: Key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(k, shape, float32)``, within an ulp or two."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = uniform(k, shape, lo, 1.0)
    return np.float32(np.sqrt(2)) * _erfinv(u)


def he_normal(k: Key, shape: Sequence[int], fan_in: int) -> np.ndarray:
    """The JAX layers' ``he_normal``: ``normal · sqrt(2 / fan_in)``."""
    return normal(k, shape) * np.float32(np.sqrt(2.0 / fan_in))
