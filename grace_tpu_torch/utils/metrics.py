"""Bytes-on-wire accounting; counterpart of the JAX package's
``utils/metrics.py`` (its ``payload_nbytes``; the reports wait for their
own slice).

The count is of *logical* payload bytes: what the codec's payload tensors
hold, not what a collective pads them to.
"""

from __future__ import annotations

import math

import torch

from grace_tpu_torch.core import Compressor, LeafKey

__all__ = ["payload_nbytes"]


def payload_nbytes(compressor: Compressor, x) -> int:
    """Logical wire bytes of ``compressor``'s payload for one tensor.

    ``x`` is a tensor, or a ``(shape, dtype)`` pair. An analytic
    ``Compressor.wire_nbytes`` wins. Otherwise zeros of the shape and dtype
    are encoded on the CPU, where every kernel wrapper runs its plain
    version, and the payload tensors' bytes are summed: torch's ``meta``
    device cannot run the kernels, and the payload's shapes do not depend
    on the values.
    """
    if isinstance(x, torch.Tensor):
        shape, dtype = tuple(x.shape), x.dtype
    else:
        shape, dtype = x
        shape = tuple(shape)
    declared = compressor.wire_nbytes(shape, dtype)
    if declared is not None:
        return int(declared)
    zeros = torch.zeros(shape, dtype=dtype)
    payload, _, _ = compressor.compress(zeros, compressor.init_state(zeros),
                                        LeafKey(0, 0, 0))
    return sum(math.prod(t.shape) * t.element_size() for t in payload)
