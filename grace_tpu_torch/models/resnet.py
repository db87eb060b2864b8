"""ResNet-50/101/152 v1.5 (stride on the bottleneck's 3×3); counterpart of
the JAX ``models/resnet.py``.

Parameter names follow the JAX tree paths (``stem.w``, ``stem_bn.scale``,
``s0b0.conv1.w``, ``s0b0.proj_bn.bias``, ``fc.w``, …) and layouts stay
JAX's (HWIO kernels, ``(din, dout)`` dense weights), so per-leaf chunk
Top-K sees the same flat buffers in both packages. ``forward`` takes NHWC
input, as ``resnet.apply`` does, and returns float32 logits.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from grace_tpu_torch.models.layers import (BatchNorm, Conv, Dense,
                                           global_avg_pool)
from grace_tpu_torch.parallel import resolve_device

STAGES_50 = (3, 4, 6, 3)
# depth -> blocks a stage, as the JAX package's ``_STAGES``.
STAGES = {50: STAGES_50, 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cmid: int, stride: int, *,
                 generator: torch.Generator):
        super().__init__()
        cout = cmid * 4
        self.conv1 = Conv(1, 1, cin, cmid, generator=generator)
        self.bn1 = BatchNorm(cmid)
        self.conv2 = Conv(3, 3, cmid, cmid, stride, generator=generator)
        self.bn2 = BatchNorm(cmid)
        self.conv3 = Conv(1, 1, cmid, cout, generator=generator)
        self.bn3 = BatchNorm(cout)
        if stride != 1 or cin != cout:
            self.proj = Conv(1, 1, cin, cout, stride, generator=generator)
            self.proj_bn = BatchNorm(cout)
        else:
            self.proj = self.proj_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)), inplace=True)
        y = F.relu(self.bn2(self.conv2(y)), inplace=True)
        y = self.bn3(self.conv3(y))
        shortcut = x if self.proj is None else self.proj_bn(self.proj(x))
        return F.relu(y + shortcut, inplace=True)


class ResNet(nn.Module):
    """ResNet v1.5 with ``blocks[s]`` bottlenecks in stage ``s``; a stage of
    0 blocks is skipped (the fc then takes the last built stage's width)."""

    def __init__(self, blocks: Sequence[int] = STAGES_50,
                 num_classes: int = 1000, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        # Initialise on the CPU from one seeded stream, then move: the same
        # seed gives the same weights on every device.
        gen = torch.Generator().manual_seed(seed)
        self.stem = Conv(7, 7, 3, 64, 2, generator=gen)
        self.stem_bn = BatchNorm(64)
        self.block_names = []
        cin = 64
        for stage, n in enumerate(blocks):
            cmid = 64 * 2 ** stage
            for b in range(n):
                stride = 2 if (b == 0 and stage > 0) else 1
                name = f"s{stage}b{b}"
                self.add_module(name, Bottleneck(cin, cmid, stride,
                                                 generator=gen))
                self.block_names.append(name)
                cin = cmid * 4
        self.fc = Dense(cin, num_classes, generator=gen)
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, 3) NHWC → logits (N, num_classes), float32."""
        y = x.permute(0, 3, 1, 2)           # NCHW view of channels-last data
        y = F.relu(self.stem_bn(self.stem(y)), inplace=True)
        # JAX pads with -inf by 1 and pools 3×3/2 VALID: the same function.
        y = F.max_pool2d(y, kernel_size=3, stride=2, padding=1)
        for name in self.block_names:
            y = getattr(self, name)(y)
        return self.fc(global_avg_pool(y).float())


def resnet50(num_classes: int = 1000, *, device="cuda", seed: int = 0
             ) -> ResNet:
    return ResNet(STAGES[50], num_classes, device=device, seed=seed)


def resnet101(num_classes: int = 1000, *, device="cuda", seed: int = 0
              ) -> ResNet:
    return ResNet(STAGES[101], num_classes, device=device, seed=seed)


def resnet152(num_classes: int = 1000, *, device="cuda", seed: int = 0
              ) -> ResNet:
    return ResNet(STAGES[152], num_classes, device=device, seed=seed)
