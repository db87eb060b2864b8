"""PyTorch synthetic throughput benchmark through the port's
``DistributedOptimizer``.

The port's twin of the repository's ``examples/torch_synthetic_benchmark.py``,
the reference's ``pytorch_synthetic_benchmark.py`` workflow: a fixed random
batch, img/s over timed iterations (mean ±1.96σ). The model is a small
convolutional trunk with a wide head, so most parameters sit in the
exchange.

One rank on the card, Top-K 1% chunk + residual:

    python -m grace_tpu_torch.examples.torch_synthetic_benchmark \\
        --compressor topk --topk-algorithm chunk --memory residual

Two gloo ranks on the CPU:

    python -m grace_tpu_torch.examples.torch_synthetic_benchmark \\
        --device cpu --nproc 2 --num-iters 2
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from grace_tpu_torch import grace_from_params
from grace_tpu_torch.examples import common
from grace_tpu_torch.interop.torch import (DistributedOptimizer,
                                           broadcast_parameters)
from grace_tpu_torch.utils import rank_zero_print


class BenchNet(torch.nn.Module):
    """Small conv trunk, wide head: most parameters sit in the exchange."""

    def __init__(self, width: int = 512, num_classes: int = 1000):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(3, 32, 3, stride=2, padding=1)
        self.conv2 = torch.nn.Conv2d(32, 64, 3, stride=2, padding=1)
        self.fc1 = torch.nn.Linear(64, width)
        self.fc2 = torch.nn.Linear(width, width)
        self.fc3 = torch.nn.Linear(width, num_classes)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        x = x.mean(dim=(2, 3))
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    common.add_grace_args(parser)
    parser.set_defaults(compressor="signum", memory="residual")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--image-size", type=int, default=64)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--num-iters", type=int, default=10)
    parser.add_argument("--num-batches-per-iter", type=int, default=10)
    parser.add_argument("--num-warmup-batches", type=int, default=10)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--bucket-cap-mb", type=float, default=32.0,
                        help="exchange bucket size for backward overlap; "
                             "0 = one bucket, launched at the last hook")
    common.add_rank_args(parser)
    return parser


def bench(argv, group, dev) -> float:
    """Run the benchmark as this rank of ``group``; the mean img/s."""
    args = build_parser().parse_args(argv)
    torch.manual_seed(args.seed)
    model = BenchNet(num_classes=args.num_classes).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    rank_zero_print(f"Model: BenchNet, {n_params / 1e6:.1f}M params, "
                    f"batch {args.batch_size}/process, device {dev}")
    grace = grace_from_params(common.grace_params_from_args(args),
                              group=group)
    broadcast_parameters(model.state_dict(), root_rank=0, group=group)
    opt = torch.optim.SGD(model.parameters(), lr=args.lr)
    opt = DistributedOptimizer(opt, grace,
                               named_parameters=model.named_parameters(),
                               group=group, seed=args.seed,
                               bucket_cap_mb=args.bucket_cap_mb or None)

    rng = np.random.default_rng(args.seed)
    data = torch.from_numpy(rng.standard_normal(
        (args.batch_size, 3, args.image_size, args.image_size)
    ).astype(np.float32)).to(dev)
    target = torch.from_numpy(rng.integers(
        0, args.num_classes, (args.batch_size,)).astype(np.int64)).to(dev)

    def run_batch():
        opt.zero_grad()
        loss = F.cross_entropy(model(data), target)
        loss.backward()
        opt.step()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(args.num_warmup_batches):
        run_batch()
    per_iter = []
    for i in range(args.num_iters):
        sync()
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            run_batch()
        sync()
        ips = args.batch_size * args.num_batches_per_iter / (
            time.perf_counter() - t0)
        per_iter.append(ips)
        rank_zero_print(f"Iter #{i}: {ips:.1f} img/sec per process")
    mean = float(np.mean(per_iter))
    rank_zero_print(f"Img/sec per process: {mean:.1f} "
                    f"+-{1.96 * float(np.std(per_iter)):.1f}")
    return mean


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    common.run_ranks(bench, argv, build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
