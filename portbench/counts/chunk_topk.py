"""Bytes the chunk Top-K kernels must move (``grace_tpu_torch/csrc/
chunk_topk.cu``), the arithmetic of ``chip_smoke.py``'s phase [3], copied.

Over leaves of ``ns`` elements keeping ``k = max(1, int(ratio · n))``
each (N and K their sums): the compress reads the gradient and the
residual and writes the residual (12·N) and writes the payload's float32
values and int32 indices (8·K); the aggregate reads W ranks' payloads
(8·W·K) and writes the dense float32 result (4·N). Each byte once.
"""

from __future__ import annotations

from typing import Iterable, Tuple


def kept(n: int, ratio: float) -> int:
    return max(1, int(n * ratio))


def totals(ns: Iterable[int], ratio: float) -> Tuple[int, int]:
    """(N, K) over the leaves the kernels take (``n >= 2k``)."""
    big_n = big_k = 0
    for n in ns:
        k = kept(n, ratio)
        if n >= 2 * k:
            big_n, big_k = big_n + n, big_k + k
    return big_n, big_k


def compress_bytes(ns: Iterable[int], ratio: float) -> int:
    n, k = totals(ns, ratio)
    return 12 * n + 8 * k


def aggregate_bytes(ns: Iterable[int], ratio: float, world: int) -> int:
    n, k = totals(ns, ratio)
    return 4 * n + 8 * world * k
