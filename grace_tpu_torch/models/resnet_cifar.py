"""cifar10-fast ResNet, the DAWNBench net; counterpart of the JAX
``models/resnet_cifar.py``.

prep conv 64 → l1 conv 128 + pool + residual(128) → l2 conv 256 + pool →
l3 conv 512 + pool + residual(512) → global max → linear without bias ×
0.125. Every conv is 3×3 SAME conv → BatchNorm → ReLU; a residual is two
of them added to their input.

Parameter names are the JAX tree paths (``prep.conv.w``, ``prep.bn.scale``,
``l1res.res1.conv.w``, …, ``fc.w``), BatchNorm state the buffers
``<block>.bn.{mean,var}``. ``forward`` takes NHWC input, as
``resnet_cifar.apply`` does, and returns logits in the input's dtype (the
JAX model does not cast them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from grace_tpu_torch.models.layers import BatchNorm, Conv, Dense, max_pool
from grace_tpu_torch.parallel import resolve_device

LOGIT_SCALE = 0.125


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, *, generator: torch.Generator):
        super().__init__()
        self.conv = Conv(3, 3, cin, cout, generator=generator)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class Residual(nn.Module):
    def __init__(self, c: int, *, generator: torch.Generator):
        super().__init__()
        self.res1 = ConvBN(c, c, generator=generator)
        self.res2 = ConvBN(c, c, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.res2(self.res1(x))


class ResNetCifar(nn.Module):
    def __init__(self, num_classes: int = 10, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.prep = ConvBN(3, 64, generator=gen)
        self.l1 = ConvBN(64, 128, generator=gen)
        self.l1res = Residual(128, generator=gen)
        self.l2 = ConvBN(128, 256, generator=gen)
        self.l3 = ConvBN(256, 512, generator=gen)
        self.l3res = Residual(512, generator=gen)
        self.fc = Dense(512, num_classes, init="he", use_bias=False,
                        generator=gen)
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, 32, 32, 3) NHWC → logits (N, num_classes)."""
        y = self.prep(x.permute(0, 3, 1, 2))      # NCHW view
        y = self.l1res(max_pool(self.l1(y), 2))
        y = max_pool(self.l2(y), 2)
        y = self.l3res(max_pool(self.l3(y), 2))
        y = y.amax(dim=(2, 3))                    # global max over H and W
        return self.fc(y) * LOGIT_SCALE
