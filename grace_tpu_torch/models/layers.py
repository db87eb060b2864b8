"""Layers with the JAX package's parameter layout and numerics.

Counterpart of the JAX ``models/layers.py``. Parameters keep the JAX
layout at the public surface, so a parameter here is the same flat buffer
as there: conv kernels HWIO, dense weights ``(din, dout)``, BatchNorm
``scale``/``bias`` with running ``mean``/``var`` buffers. Inside, the
layers work on NCHW tensors stored channels-last (the free view of an NHWC
tensor), the layout cuDNN prefers; each conv permutes and casts its HWIO
kernel per call.

Numerics follow the JAX layers, not PyTorch's defaults:

* SAME padding is XLA's: at stride 2 it pads one more row and column at
  the high end than at the low end (the 7×7/2 stem at 224 pads (2, 3),
  a 3×3/2 conv at 56 pads (0, 1)). Symmetric ``padding=`` would shift
  every stride-2 output, so asymmetric cases pad explicitly.
* The conv kernel is cast to the activation's dtype, so a bfloat16 input
  runs the conv in bfloat16 over float32 master weights. No autocast.
* BatchNorm normalises in float32 with the biased batch variance, casts
  back to the input's dtype, and updates its running stats as
  ``0.9·old + 0.1·new`` with that same biased variance (``nn.BatchNorm2d``
  would store the unbiased one).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def same_padding(size: int, window: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding (low, high) of one spatial dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def he_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    std = math.sqrt(2.0 / fan_in)
    return torch.empty(shape).normal_(0.0, std, generator=generator)


def glorot_uniform(shape, fan_in: int, fan_out: int,
                   generator: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


class Conv(nn.Module):
    """Convolution with an HWIO kernel ``w``, XLA ``padding`` (``"SAME"`` or
    ``"VALID"``) and, with ``use_bias``, a bias ``b``; takes and returns
    NCHW tensors."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int, stride: int = 1,
                 *, padding: str = "SAME", use_bias: bool = False,
                 generator: torch.Generator):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME' or 'VALID'; got "
                             f"{padding!r}")
        self.stride = stride
        self.padding = padding
        self.w = nn.Parameter(he_normal((kh, kw, cin, cout), kh * kw * cin,
                                        generator))
        self.b = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # HWIO -> OIHW, cast to the activation dtype, channels-last storage.
        w = self.w.permute(3, 2, 0, 1).to(dtype=x.dtype,
                                          memory_format=torch.channels_last)
        if self.padding == "VALID":
            y = F.conv2d(x, w, stride=self.stride)
        else:
            kh, kw = self.w.shape[:2]
            top, bottom = same_padding(x.shape[2], kh, self.stride)
            left, right = same_padding(x.shape[3], kw, self.stride)
            if top == bottom and left == right:
                y = F.conv2d(x, w, stride=self.stride, padding=(top, left))
            else:
                y = F.conv2d(F.pad(x, (left, right, top, bottom)), w,
                             stride=self.stride)
        if self.b is None:
            return y
        # Added after the convolution, as the JAX layer adds it.
        return y + self.b.to(y.dtype).view(1, -1, 1, 1)


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` of shape ``(din, dout)``, initialised by
    ``init``: ``"glorot"`` (uniform) or ``"he"`` (normal). The JAX
    ``dense_init`` defaults to ``"he"``; ResNet's fc passes ``"glorot"``
    there, which is this layer's default."""

    def __init__(self, din: int, dout: int, *, init: str = "glorot",
                 generator: torch.Generator):
        super().__init__()
        if init == "glorot":
            w = glorot_uniform((din, dout), din, dout, generator)
        elif init == "he":
            w = he_normal((din, dout), din, generator)
        else:
            raise ValueError(f"init must be 'glorot' or 'he'; got {init!r}")
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros(dout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w.to(x.dtype) + self.b.to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over N, H and W of an NCHW tensor, with the JAX package's
    statistics (see the module docstring). Running stats are per process;
    the train step averages them over the group."""

    momentum = 0.9
    eps = 1e-5

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                                training=False, eps=self.eps)
        # Normalise with the batch's own statistics (biased variance, float32
        # internally, output in x's dtype). No running stats are passed, so
        # the op leaves the buffers alone; it returns the batch mean and
        # 1/sqrt(var + eps), from which the biased variance is recovered
        # without a second pass over x.
        y, mean, invstd = torch.native_batch_norm(
            x, self.scale, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = invstd.pow(-2) - self.eps
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return y


def max_pool(x: torch.Tensor, window: int = 2,
             stride: Optional[int] = None) -> torch.Tensor:
    """VALID max pool of an NCHW tensor."""
    return F.max_pool2d(x, window, stride or window)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W of an NCHW tensor."""
    return x.mean(dim=(2, 3))
