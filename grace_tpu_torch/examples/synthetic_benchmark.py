"""Synthetic throughput benchmark: ResNet, VGG, BERT or BenchNet on a fixed
random batch.

The port's twin of the repository's ``examples/synthetic_benchmark.py``,
with the same flags, defaults and timing protocol: ``--num-warmup-batches``
steps, then ``--num-iters`` windows of ``--num-batches-per-iter`` steps,
each window ended by a synchronisation; items/s per window, printed as the
mean ±1.96σ, and the wire cost (``utils.wire_report``) of the configured
codec over the model's leaves. Every rank trains on its ``--batch-size``
rows of one global batch drawn from ``default_rng(seed)``, through the
GRACE transform and SGD at ``--lr``.

``--model``: ``resnet50``, ``resnet101``, ``resnet152``,
``vgg{11,13,16,19}[_bn]`` (torchvision's names: ``vgg16`` plain,
``vgg16_bn`` with BatchNorm), ``bert`` (BERT-base, classification over
``--seq-len`` tokens) or ``benchnet`` (the JAX example's BenchNet: conv
3→32/2, conv 32→64/2, global mean, fc 64→512→512→C).

One rank on the card:

    python -m grace_tpu_torch.examples.synthetic_benchmark --model vgg16 \\
        --compressor topk --topk-algorithm chunk --memory residual \\
        --fusion none

Two gloo ranks on the CPU:

    python -m grace_tpu_torch.examples.synthetic_benchmark --device cpu \\
        --nproc 2 --model benchnet --image-size 32 --num-iters 2
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from grace_tpu_torch import grace_from_params
from grace_tpu_torch.examples import common
from grace_tpu_torch.models import resnet, transformer, vgg
from grace_tpu_torch.models.layers import Conv, Dense
from grace_tpu_torch.parallel import resolve_device
from grace_tpu_torch.train import (init_stateful_train_state,
                                   make_stateful_train_step)
from grace_tpu_torch.utils import rank_zero_print, wire_report


class BenchNet(nn.Module):
    """The JAX synthetic benchmark's BenchNet: biased SAME convs, he-init
    dense layers, float32 logits."""

    def __init__(self, num_classes: int, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.conv1 = Conv(3, 3, 3, 32, 2, use_bias=True, generator=gen)
        self.conv2 = Conv(3, 3, 32, 64, 2, use_bias=True, generator=gen)
        self.fc1 = Dense(64, 512, init="he", generator=gen)
        self.fc2 = Dense(512, 512, init="he", generator=gen)
        self.fc3 = Dense(512, num_classes, init="he", generator=gen)
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.permute(0, 3, 1, 2)
        y = F.relu(self.conv1(y))
        y = F.relu(self.conv2(y))
        y = y.mean(dim=(2, 3))
        y = F.relu(self.fc1(y))
        y = F.relu(self.fc2(y))
        return self.fc3(y).float()


def build(args, dev, rank: int, world: int):
    """The model, its loss and this rank's rows of the global batch."""
    dtype = common.compute_dtype(dev)
    rng = np.random.default_rng(args.seed)
    n = args.batch_size * world
    rows = slice(rank * args.batch_size, (rank + 1) * args.batch_size)
    name = args.model
    if name == "bert":
        cfg = transformer.base(num_classes=args.num_classes)
        model = transformer.Transformer(cfg, device=dev, seed=args.seed)
        x = rng.integers(0, cfg.vocab_size, (n, args.seq_len))
        x = torch.from_numpy(x[rows]).long().to(dev)

        def forward(m, inputs):
            return m(inputs, dtype=dtype)
    else:
        if name in ("resnet50", "resnet101", "resnet152"):
            model = getattr(resnet, name)(args.num_classes, device=dev,
                                          seed=args.seed)
        elif name.startswith("vgg"):
            try:
                model = vgg.vgg(name, args.num_classes, device=dev,
                                seed=args.seed)
            except ValueError:
                raise SystemExit(f"unknown --model {name}") from None
        elif name == "benchnet":
            model = BenchNet(args.num_classes, device=dev, seed=args.seed)
        else:
            raise SystemExit(f"unknown --model {name}")
        x = rng.standard_normal((n, args.image_size, args.image_size, 3))
        x = torch.from_numpy(x[rows].astype(np.float32)).to(dev)

        def forward(m, inputs):
            return m(inputs.to(dtype))
    y = rng.integers(0, args.num_classes, (n,))
    y = torch.from_numpy(y[rows]).long().to(dev)

    def loss_fn(m, batch):
        return F.cross_entropy(forward(m, batch[0]).float(), batch[1])

    return model, loss_fn, (x, y)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    common.add_grace_args(parser)
    parser.add_argument("--model", default="resnet50",
                        help="resnet50|resnet101|resnet152|vgg{11,13,16,19}"
                             "[_bn]|bert|benchnet")
    parser.add_argument("--batch-size", type=int, default=32,
                        help="per-rank batch (reference default 32)")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--num-iters", type=int, default=10,
                        help="timed iterations (reference protocol: 10)")
    parser.add_argument("--num-batches-per-iter", type=int, default=10)
    parser.add_argument("--num-warmup-batches", type=int, default=10)
    parser.add_argument("--lr", type=float, default=0.01)
    common.add_rank_args(parser)
    return parser


def bench(args, group, dev) -> float:
    """Run the benchmark as this rank of ``group``; the mean items/s of
    the group."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    model, loss_fn, batch = build(args, dev, rank, world)
    grace = grace_from_params(common.grace_params_from_args(args),
                              group=group)
    tx = grace.transform(seed=args.seed)
    state = init_stateful_train_state(
        model, tx, torch.optim.SGD(model.parameters(), lr=args.lr), group)
    step = make_stateful_train_step(loss_fn, tx, group)
    rank_zero_print(f"Model: {args.model}, global batch "
                    f"{args.batch_size * world} over {world} ranks "
                    f"({dev.type})")
    rank_zero_print("wire cost:", wire_report(grace.compressor,
                                              dict(model.named_parameters())))

    loss = None
    for _ in range(args.num_warmup_batches):
        state, loss = step(state, batch)
    if loss is not None:
        float(loss)                       # waits for the device
    items = args.batch_size * world * args.num_batches_per_iter
    unit = "seq" if args.model == "bert" else "img"
    per_iter = []
    for i in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            state, loss = step(state, batch)
        float(loss)                       # the steps are dependent
        per_iter.append(items / (time.perf_counter() - t0))
        rank_zero_print(f"Iter #{i}: {per_iter[-1]:.1f} {unit}/sec")
    mean = float(np.mean(per_iter))
    rank_zero_print(f"{unit}/sec: {mean:.1f} "
                    f"+-{1.96 * float(np.std(per_iter)):.1f}")
    rank_zero_print(f"{unit}/sec/device: {mean / world:.1f}")
    return mean


def run(argv, group, dev) -> float:
    return bench(build_parser().parse_args(argv), group, dev)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    common.run_ranks(run, argv, build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
