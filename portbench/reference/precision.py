"""The precisions the reference computes in.

``float32``: the reference itself, everything in full float32 (TF32
off, :func:`no_tf32`). ``float8``: the control, the reference computed
one precision below the configurations' bfloat16: wherever the
configuration computes in its compute dtype, the control rounds to
float8. Each weight is read rounded to e4m3 (:meth:`Precision.weight`);
each activation the model produces is rounded to e4m3 forward and its
gradient to e5m2 backward (:meth:`Precision.act`), the usual fp8
training formats; each with a per-tensor scale (amax to 448 and to
57344), as quantise-dequantise around float32 arithmetic. The reference
models call both at the points where the port's models round to their
compute dtype; in float32 both are the identity.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _qdq(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _Weight(torch.autograd.Function):
    """e4m3 rounding forward; the gradient passes straight through to the
    float32 master weight."""

    @staticmethod
    def forward(ctx, t):
        return _qdq(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Act(torch.autograd.Function):
    """e4m3 rounding forward; the gradient rounded to e5m2 backward."""

    @staticmethod
    def forward(ctx, t):
        return _qdq(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _qdq(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """Where the reference rounds, and to what."""

    def __init__(self, name: str):
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def weight(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.name == "float32" else _Weight.apply(t)

    def act(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.name == "float32" else _Act.apply(t)


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """Float32 products in float32, restored on exit."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
