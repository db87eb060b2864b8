"""LeNet-style MNIST CNN; counterpart of the JAX ``models/lenet.py``.

conv 10@5×5 (VALID) → max pool 2 → ReLU → conv 20@5×5 → pool → ReLU →
flatten → fc 320→50 → ReLU → fc 50→10, pool before ReLU as in the JAX
model. Parameter names are the JAX tree paths (``conv1.w``, ``conv1.b``,
…, ``fc2.b``) and layouts stay JAX's, so ``convert.from_jax`` carries
``lenet.init``'s parameters across unchanged. No BatchNorm, so no buffers.

The flatten reads an NHWC tensor, as JAX reshapes its ``(N, 4, 4, 20)``
activation: ``fc1.w``'s 320 rows are in H, W, C order.

The initial weights are the JAX package's: ``LeNet(seed=s)`` draws them
with the JAX package's Threefry keys (``models/threefry.py``), so it starts
within a few ulps of ``lenet.init(jax.random.key(s))``, the biases at zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from grace_tpu_torch.models import threefry
from grace_tpu_torch.models.layers import Conv, Dense, max_pool
from grace_tpu_torch.parallel import resolve_device


class LeNet(nn.Module):
    """``forward`` takes NHWC ``(N, 28, 28, 1)`` input, as ``lenet.apply``
    does, and returns logits ``(N, 10)``."""

    def __init__(self, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.conv1 = Conv(5, 5, 1, 10, padding="VALID", use_bias=True,
                          generator=gen)
        self.conv2 = Conv(5, 5, 10, 20, padding="VALID", use_bias=True,
                          generator=gen)
        self.fc1 = Dense(320, 50, init="he", generator=gen)
        self.fc2 = Dense(50, 10, init="he", generator=gen)
        # lenet.init's draws: split(key(seed), 4), one key a layer, on the
        # CPU and then moved, so every device starts from the same weights.
        keys = threefry.split(threefry.key(seed), 4)
        with torch.no_grad():
            for k, layer, fan_in in zip(keys, (self.conv1, self.conv2,
                                               self.fc1, self.fc2),
                                        (25, 250, 320, 50)):
                layer.w.copy_(torch.from_numpy(threefry.he_normal(
                    k, tuple(layer.w.shape), fan_in)))
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.permute(0, 3, 1, 2)           # NCHW view of the NHWC input
        y = F.relu(max_pool(self.conv1(y), 2))
        y = F.relu(max_pool(self.conv2(y), 2))
        y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)    # NHWC order
        y = F.relu(self.fc1(y))
        return self.fc2(y)
