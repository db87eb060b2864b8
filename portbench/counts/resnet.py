"""Operations of a ResNet v1.5 training step, from the layer shapes.

A convolution of a ``kh × kw × cin → cout`` kernel over an output of
``ho × wo`` costs ``ho · wo · kh · kw · cin · cout`` multiply-adds an
image; the classifier ``din · dout``. BatchNorm, ReLU, the pools and the
residual adds are left out, as torchvision's published 4.09 GMAC of
ResNet-50 at 224² leaves them out. A step is the forward and the backward:
3 × the forward's multiply-adds, 2 operations each (the convention of the
port's ``models/transformer.n_flops``).
"""

from __future__ import annotations

import math


def forward_macs(config) -> int:
    """Multiply-adds of one image's forward pass."""
    s, w0 = config["image_size"], config["stem_width"]
    size = math.ceil(s / 2)                         # the 7×7/2 stem
    macs = size * size * 7 * 7 * config["channels"] * w0
    size = math.ceil(size / 2)                      # the 3×3/2 max pool
    cin = w0
    for stage, n in enumerate(config["blocks"]):
        cmid = w0 * 2 ** stage
        cout = cmid * config["bottleneck_expansion"]
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            out = math.ceil(size / stride)
            macs += size * size * cin * cmid                # conv1, 1×1
            macs += out * out * 9 * cmid * cmid             # conv2, 3×3/s
            macs += out * out * cmid * cout                 # conv3, 1×1
            if stride != 1 or cin != cout:
                macs += out * out * cin * cout              # projection
            size, cin = out, cout
    return macs + cin * config["num_classes"]


def step_flops(config, batch: int) -> int:
    """Operations of one rank's training step at ``batch`` images."""
    return 3 * 2 * forward_macs(config) * batch
