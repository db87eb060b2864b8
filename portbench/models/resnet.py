"""The port's ResNet v1.5 (``grace_tpu_torch.models.resnet``) under the
benchmark: built without weights, and the loss the train step takes."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def build(config, device) -> torch.nn.Module:
    """The port's model on ``device`` with its BatchNorm statistics at
    their start (mean 0, variance 1) and its parameters unset: the
    benchmark draws them. Built on the meta device, since the port's
    constructor draws every weight on the host first."""
    from grace_tpu_torch.models.resnet import ResNet

    if (config["stem_width"], config["bottleneck_expansion"]) != (64, 4):
        raise ValueError("the port's ResNet has a stem of 64 and "
                         "bottlenecks of expansion 4")

    class Unplaced(ResNet):
        def to(self, *args, **kwargs):
            return self

    with torch.device("meta"):
        model = Unplaced(tuple(config["blocks"]), config["num_classes"],
                         device="cpu", seed=0)
    model.__class__ = ResNet
    model.to_empty(device=device)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.fill_(1.0 if name.endswith(".var") else 0.0)
    return model


def loss(config, half_batch: bool = False):
    """``loss(model, (images, labels))``: cross-entropy of the logits of
    images cast to the compute dtype. ``half_batch`` plants a fault: the
    mean over the first half of the batch alone."""
    dtype = getattr(torch, config["compute_dtype"])

    def fn(model, batch):
        x, y = batch
        if half_batch:
            x, y = x[:x.shape[0] // 2], y[:y.shape[0] // 2]
        return F.cross_entropy(model(x.to(dtype)), y)

    return fn
