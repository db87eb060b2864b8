"""VGG-11/13/16/19, with or without BatchNorm; counterpart of the JAX
``models/vgg.py``.

Stacked 3×3 SAME convs between 2×2 max pools (the plans of arXiv:1409.1556
Table 1), each conv followed by BatchNorm (the ``_bn`` variants, whose
convs have no bias) or not (a conv bias instead), and ReLU; the features
pooled to a 7×7 grid (torchvision's adaptive average pool, any input of
32 or more pixels), flattened to fc1's 25,088 inputs; fc1 → ReLU → fc2 →
ReLU → fc3, ``he`` init with biases. No dropout, as in the JAX model.

Parameter names are the JAX tree's keys: ``conv<li>.{w,b}`` and
``bn<li>.{scale,bias}`` at the conv's index ``li`` in the plan (pools
included), ``fc1``..``fc3``. The flatten reads the features in NHWC order,
as JAX reshapes its ``(N, 7, 7, 512)`` activation, so fc1's ``(25088,
4096)`` weight carries over as it is. ``forward`` takes NHWC input and
returns float32 logits under any compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from grace_tpu_torch.models.layers import (BatchNorm, Conv, Dense,
                                           adaptive_avg_pool, max_pool)
from grace_tpu_torch.parallel import resolve_device

PLANS = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    13: (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
         512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}
GRID = 7


class VGG(nn.Module):
    def __init__(self, depth: int = 16, num_classes: int = 1000,
                 batch_norm: bool = True, *, device="cuda", seed: int = 0):
        super().__init__()
        if depth not in PLANS:
            raise ValueError(f"vgg depth must be one of {sorted(PLANS)}")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.plan = PLANS[depth]
        cin = 3
        for li, v in enumerate(self.plan):
            if v == "M":
                continue
            self.add_module(f"conv{li}", Conv(3, 3, cin, v,
                                              use_bias=not batch_norm,
                                              generator=gen))
            if batch_norm:
                self.add_module(f"bn{li}", BatchNorm(v))
            cin = v
        self.batch_norm = batch_norm
        self.fc1 = Dense(GRID * GRID * 512, 4096, init="he", generator=gen)
        self.fc2 = Dense(4096, 4096, init="he", generator=gen)
        self.fc3 = Dense(4096, num_classes, init="he", generator=gen)
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, 3) NHWC, H = W >= 32 → logits (N, num_classes),
        float32."""
        y = x.permute(0, 3, 1, 2)                 # NCHW view
        for li, v in enumerate(self.plan):
            if v == "M":
                y = max_pool(y, 2)
                continue
            y = getattr(self, f"conv{li}")(y)
            if self.batch_norm:
                y = getattr(self, f"bn{li}")(y)
            y = F.relu(y)
        if y.shape[2:] != (GRID, GRID):
            y = adaptive_avg_pool(y, GRID)
        y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)   # NHWC order
        y = F.relu(self.fc1(y))
        y = F.relu(self.fc2(y))
        return self.fc3(y.float())


def vgg(name: str, num_classes: int = 1000, *, device="cuda",
        seed: int = 0) -> VGG:
    """A VGG by torchvision's name: ``vgg16`` is plain, ``vgg16_bn`` has
    BatchNorm."""
    spec = name.removeprefix("vgg")
    batch_norm = spec.endswith("_bn")
    spec = spec.removesuffix("_bn")
    if not spec.isdigit() or int(spec) not in PLANS:
        raise ValueError(f"unknown VGG {name!r}")
    return VGG(int(spec), num_classes, batch_norm, device=device, seed=seed)
