"""Plain ResNet v1.5 (He et al. 2015; the stride on the bottleneck's 3×3),
written from the paper and the configuration file alone.

Parameters are a flat dict of float32 tensors named as the benchmark
names them (``stem.w``, ``s0b0.conv1.w``, ``s0b0.proj_bn.scale``,
``fc.w``, …): kernels HWIO, the classifier ``(din, dout)``. Input NHWC.
Convolutions pad as XLA's SAME does (the extra row and column at the high
end at stride 2); BatchNorm normalises with the batch's own statistics
(biased variance) in training mode. The classifier reads the pooled
features in float32, as the configuration's model does. Also the inputs: standard normal
images and uniform labels, drawn from a generator on the device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision


def _blocks(config) -> List[Tuple[str, int, int, int]]:
    """(name, cin, cmid, stride) of every bottleneck."""
    out, cin = [], config["stem_width"]
    for stage, n in enumerate(config["blocks"]):
        cmid = config["stem_width"] * 2 ** stage
        for b in range(n):
            out.append((f"s{stage}b{b}", cin, cmid,
                        2 if (b == 0 and stage > 0) else 1))
            cin = cmid * config["bottleneck_expansion"]
    return out


def param_shapes(config) -> Dict[str, Tuple[int, ...]]:
    w0, c = config["stem_width"], config["channels"]
    shapes = {"stem.w": (7, 7, c, w0), "stem_bn.scale": (w0,),
              "stem_bn.bias": (w0,)}
    cin = w0
    for name, cin, cmid, stride in _blocks(config):
        cout = cmid * config["bottleneck_expansion"]
        shapes.update({
            f"{name}.conv1.w": (1, 1, cin, cmid),
            f"{name}.bn1.scale": (cmid,), f"{name}.bn1.bias": (cmid,),
            f"{name}.conv2.w": (3, 3, cmid, cmid),
            f"{name}.bn2.scale": (cmid,), f"{name}.bn2.bias": (cmid,),
            f"{name}.conv3.w": (1, 1, cmid, cout),
            f"{name}.bn3.scale": (cout,), f"{name}.bn3.bias": (cout,)})
        if stride != 1 or cin != cout:
            shapes.update({f"{name}.proj.w": (1, 1, cin, cout),
                           f"{name}.proj_bn.scale": (cout,),
                           f"{name}.proj_bn.bias": (cout,)})
        cin = cout
    shapes["fc.w"] = (cin, config["num_classes"])
    shapes["fc.b"] = (config["num_classes"],)
    return shapes


def make_batches(config, count: int, batch: int, gen: torch.Generator,
                 device) -> list:
    """``count`` distinct (images, labels) batches."""
    s, c = config["image_size"], config["channels"]
    x = torch.randn((count, batch, s, s, c), generator=gen, device=device)
    y = torch.randint(0, config["num_classes"], (count, batch),
                      generator=gen, device=device)
    return [(x[i], y[i]) for i in range(count)]


def _same(size: int, window: int, stride: int) -> Tuple[int, int]:
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride, prec: Precision):
    kh, kw = w.shape[:2]
    top, bottom = _same(x.shape[2], kh, stride)
    left, right = _same(x.shape[3], kw, stride)
    x = F.pad(x, (left, right, top, bottom))
    return prec.act(F.conv2d(x, prec.weight(w).permute(3, 2, 0, 1),
                             stride=stride))


def _bn(x, p, name, eps, prec: Precision):
    return prec.act(F.batch_norm(x, None, None, p[f"{name}.scale"],
                                 p[f"{name}.bias"], training=True, eps=eps))


def logits(p: Dict[str, torch.Tensor], images: torch.Tensor, config,
           prec: Precision) -> torch.Tensor:
    eps = config["batch_norm_eps"]

    def conv_bn(x, name, bn, stride):
        return _bn(_conv(x, p[f"{name}.w"], stride, prec), p, bn, eps, prec)

    x = prec.act(images.permute(0, 3, 1, 2))
    x = F.relu(conv_bn(x, "stem", "stem_bn", 2))
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
    for name, cin, cmid, stride in _blocks(config):
        y = F.relu(conv_bn(x, f"{name}.conv1", f"{name}.bn1", 1))
        y = F.relu(conv_bn(y, f"{name}.conv2", f"{name}.bn2", stride))
        y = conv_bn(y, f"{name}.conv3", f"{name}.bn3", 1)
        if f"{name}.proj.w" in p:
            x = conv_bn(x, f"{name}.proj", f"{name}.proj_bn", stride)
        x = F.relu(prec.act(y + x))
    pooled = prec.act(x.mean(dim=(2, 3)))
    return pooled @ p["fc.w"] + p["fc.b"]      # the classifier in float32


def loss(p: Dict[str, torch.Tensor], batch, config,
         prec: Precision) -> torch.Tensor:
    images, labels = batch
    return F.cross_entropy(logits(p, images, config, prec), labels)
