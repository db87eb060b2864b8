"""PyTorch MNIST through the port's ``DistributedOptimizer``.

The port's twin of the repository's ``examples/torch_mnist.py``, the
reference's ``pytorch_mnist.py`` workflow: a torch CNN, the optimizer
wrapped with ``DistributedOptimizer(opt, grace, named_parameters=...)``,
the initial state broadcast from rank 0. Each rank trains on its share of
a synthetic MNIST set (or the idx files of ``--data-dir``).

One rank on the card:

    python -m grace_tpu_torch.examples.torch_mnist

Two gloo ranks on the CPU:

    python -m grace_tpu_torch.examples.torch_mnist --device cpu --nproc 2
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from grace_tpu_torch import grace_from_params
from grace_tpu_torch.data import batches, load_mnist_idx
from grace_tpu_torch.examples import common
from grace_tpu_torch.interop.torch import (DistributedOptimizer,
                                           broadcast_optimizer_state,
                                           broadcast_parameters)
from grace_tpu_torch.utils import TableLogger, Timer, rank_zero_print


class Net(torch.nn.Module):
    """The reference example's LeNet-like CNN."""

    def __init__(self):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(1, 10, kernel_size=5)
        self.conv2 = torch.nn.Conv2d(10, 20, kernel_size=5)
        self.fc1 = torch.nn.Linear(320, 50)
        self.fc2 = torch.nn.Linear(50, 10)

    def forward(self, x):
        x = F.relu(F.max_pool2d(self.conv1(x), 2))
        x = F.relu(F.max_pool2d(self.conv2(x), 2))
        x = x.flatten(1)
        x = F.relu(self.fc1(x))
        return F.log_softmax(self.fc2(x), dim=1)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    common.add_grace_args(parser)
    parser.set_defaults(compressor="topk", compress_ratio=0.3,
                        memory="residual")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--train-size", type=int, default=8192)
    parser.add_argument("--data-dir", default=None)
    common.add_rank_args(parser)
    return parser


def train(argv, group, dev) -> list:
    """Train under ``argv`` as this rank of ``group``; the mean train loss
    of each epoch."""
    args = build_parser().parse_args(argv)
    torch.manual_seed(args.seed)
    if args.data_dir:
        x_train, y_train = load_mnist_idx(args.data_dir, train=True)
    else:
        x_train, y_train = common.synthetic_mnist(args.train_size, args.seed)
    # Each rank takes every W-th sample (the DistributedSampler's share).
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    x_train, y_train = x_train[rank::world], y_train[rank::world]
    x_train = np.ascontiguousarray(np.transpose(x_train, (0, 3, 1, 2)))

    model = Net().to(dev)
    broadcast_parameters(model.state_dict(), root_rank=0, group=group)
    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.5)
    broadcast_optimizer_state(optimizer, root_rank=0, group=group)
    grace = grace_from_params(common.grace_params_from_args(args),
                              group=group)
    optimizer = DistributedOptimizer(
        optimizer, grace, named_parameters=model.named_parameters(),
        group=group, seed=args.seed)

    sync = torch.cuda.synchronize if dev.type == "cuda" else None
    log, timer, curve = TableLogger(), Timer(sync), []
    for epoch in range(1, args.epochs + 1):
        model.train()
        losses = []
        for xb, yb in batches(x_train, y_train, args.batch_size,
                              shuffle=True, seed=args.seed + epoch):
            optimizer.zero_grad()
            out = model(torch.from_numpy(xb).to(dev))
            loss = F.nll_loss(out, torch.from_numpy(yb).long().to(dev))
            loss.backward()
            optimizer.step()
            losses.append(loss.item())
        curve.append(float(np.mean(losses)))
        if rank == 0:
            log.append({"epoch": epoch, "train loss": curve[-1],
                        "epoch time": timer()})
    rank_zero_print(f"final train loss {curve[-1]:.4f}")
    return curve


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    common.run_ranks(train, argv, build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
