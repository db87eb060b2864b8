"""CIFAR-10 DAWNBench-style training: the cifar10-fast ResNet, 24 epochs,
a TSV log.

The port's twin of the repository's ``examples/cifar10_dawn.py``, with the
same flags and defaults: 24 epochs, a global batch of 512, the
piecewise-linear rate (0 → 0.4 at epoch 5 → 0 at epoch 24), SGD with
Nesterov momentum 0.9 and weight decay 5e-4 applied after the exchange,
pad-reflect-4 / random-crop / flip augmentation drawn from
``default_rng(seed)``, and the DAWNBench TSV (epoch, cumulative hours of
training, top-1 %) with the run's provenance, rewritten every epoch.
Evaluation time is left out of the clock. Each rank takes its contiguous
``B/W`` rows of every global batch and of every evaluation batch.

Without ``--data-dir`` it trains on the synthetic set (8,192 train images,
``SYNTHETIC_TEST_SIZE`` test images): a check of the plumbing, not the 94%
DAWNBench claim, which needs the CIFAR-10 binary batches. The loss reads
the logits in float32.

One rank on the card, Top-K 1% chunk over the flat gradient:

    python -m grace_tpu_torch.examples.cifar10_dawn --compressor topk \\
        --topk-algorithm chunk --memory residual --tsv run.tsv

Two gloo ranks on the CPU, a short run:

    python -m grace_tpu_torch.examples.cifar10_dawn --device cpu --nproc 2 \\
        --epochs 2 --batch-size 64 --train-size 256
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from grace_tpu_torch import grace_from_params
from grace_tpu_torch.data import batches, load_cifar10_binary
from grace_tpu_torch.examples import common
from grace_tpu_torch.models.resnet_cifar import ResNetCifar
from grace_tpu_torch.train import (init_stateful_train_state, make_eval_step,
                                   make_stateful_train_step, set_lr)
from grace_tpu_torch.utils import (TableLogger, Timer, TSVLogger,
                                   rank_zero_print, run_provenance)

# The synthetic test set's size, fixed as in the JAX example.
SYNTHETIC_TEST_SIZE = 2048


def piecewise_linear_lr(step, steps_per_epoch, peak_epoch=5, total_epochs=24,
                        peak_lr=0.4) -> float:
    """The cifar10-fast rate: 0 → ``peak_lr`` at ``peak_epoch``, then
    linearly to 0 at ``total_epochs``; a run no longer than the peak puts
    it at its midpoint. In float32, operation for operation as the JAX
    example computes it for an int32 step."""
    if total_epochs <= peak_epoch:
        peak_epoch = max(1, total_epochs // 2)
    f32 = np.float32
    e = f32(step) / f32(steps_per_epoch)
    if e < peak_epoch:
        return float(f32(peak_lr) * e / f32(peak_epoch))
    tail = (f32(total_epochs) - e) / f32(max(total_epochs - peak_epoch, 1e-9))
    return float(f32(peak_lr) * max(f32(0.0), tail))


def augment(x, rng):
    """Pad-reflect 4, random 32×32 crop, horizontal flip, vectorised over
    the NHWC batch: the JAX example's draws, in its order."""
    n = x.shape[0]
    padded = np.pad(x, [(0, 0), (4, 4), (4, 4), (0, 0)], mode="reflect")
    dx = rng.integers(0, 9, n)
    dy = rng.integers(0, 9, n)
    rows = dy[:, None, None] + np.arange(32)[None, :, None]   # (n, 32, 1)
    cols = dx[:, None, None] + np.arange(32)[None, None, :]   # (n, 1, 32)
    out = padded[np.arange(n)[:, None, None], rows, cols]
    flip = rng.random(n) < 0.5
    out[flip] = out[flip, :, ::-1]
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    common.add_grace_args(parser)
    parser.add_argument("--epochs", type=int, default=24)
    parser.add_argument("--batch-size", type=int, default=512,
                        help="global batch (split across the ranks)")
    parser.add_argument("--peak-lr", type=float, default=0.4)
    parser.add_argument("--weight-decay", type=float, default=5e-4)
    parser.add_argument("--data-dir", default=None,
                        help="CIFAR-10 binary batches dir (default synthetic)")
    parser.add_argument("--train-size", type=int, default=8192,
                        help="synthetic dataset size")
    parser.add_argument("--no-augment", action="store_true")
    parser.add_argument("--tsv", default="logs.tsv")
    common.add_rank_args(parser)
    return parser


def _loss_fn(dtype):
    def loss(model, batch):
        x, y = batch
        return F.cross_entropy(model(x.to(dtype)).float(), y)
    return loss


def _metric_fn(dtype):
    def metric(model, batch):
        x, y = batch
        correct = (model(x.to(dtype)).argmax(-1) == y).sum()
        return {"correct": correct,
                "count": torch.tensor(y.numel(), device=y.device)}
    return metric


def train(args, group, dev, log=rank_zero_print) -> dict:
    """Train under ``args`` as this rank of ``group`` on ``dev``. Returns
    the rows logged (one an epoch) and the steps taken."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if args.batch_size % world:
        raise ValueError(f"--batch-size {args.batch_size} does not split "
                         f"over {world} ranks")
    local = args.batch_size // world
    if args.data_dir:
        x_train, y_train = load_cifar10_binary(args.data_dir, True)
        x_test, y_test = load_cifar10_binary(args.data_dir, False)
    else:
        x_train, y_train = common.synthetic_cifar10(args.train_size,
                                                    args.seed)
        x_test, y_test = common.synthetic_cifar10(SYNTHETIC_TEST_SIZE,
                                                  args.seed + 1)
    if len(x_train) < args.batch_size or len(x_test) < args.batch_size:
        raise SystemExit(f"--batch-size {args.batch_size} exceeds dataset "
                         f"split sizes ({len(x_train)} train / {len(x_test)} "
                         "test)")
    steps_per_epoch = len(x_train) // args.batch_size

    def schedule(step):
        return piecewise_linear_lr(step, steps_per_epoch,
                                   total_epochs=args.epochs,
                                   peak_lr=args.peak_lr)

    grace = grace_from_params(common.grace_params_from_args(args),
                              group=group)
    tx = grace.transform(seed=args.seed)
    model = ResNetCifar(device=dev, seed=args.seed)
    opt = torch.optim.SGD(model.parameters(), lr=schedule(0), momentum=0.9,
                          nesterov=True, weight_decay=args.weight_decay)
    state = init_stateful_train_state(model, tx, opt, group)
    dtype = common.compute_dtype(dev)
    step = make_stateful_train_step(_loss_fn(dtype), tx, group)
    eval_step = make_eval_step(_metric_fn(dtype), group)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    aug_rng = np.random.default_rng(args.seed)
    # The TSV says on its face whether it trained on real CIFAR-10 or the
    # synthetic plumbing check, and on what device.
    prov = run_provenance(
        data=f"real:{args.data_dir}" if args.data_dir else "synthetic",
        recipe="cifar10_dawn 24-epoch DAWNBench", epochs=args.epochs,
        batch_size=args.batch_size, **common.grace_provenance(args))
    table, tsv, timer = TableLogger(), TSVLogger(provenance=prov), Timer(sync)
    rows_of = slice(rank * local, (rank + 1) * local)
    n_eval = len(x_test) - (len(x_test) % args.batch_size)
    rows, count = [], 0
    for epoch in range(1, args.epochs + 1):
        xs = x_train if args.no_augment else augment(x_train, aug_rng)
        losses = []
        for xb, yb in batches(xs, y_train, args.batch_size, shuffle=True,
                              seed=args.seed + epoch):
            set_lr(opt, schedule, count)
            batch = (torch.from_numpy(xb[rows_of]).to(dev),
                     torch.from_numpy(yb[rows_of]).long().to(dev))
            state, loss = step(state, batch)
            losses.append(loss)
            count += 1
        train_loss = float(torch.stack(losses).mean())     # synchronises
        train_time = timer()
        correct = total = 0.0
        for xb, yb in batches(x_test[:n_eval], y_test[:n_eval],
                              args.batch_size, shuffle=False, seed=0):
            m = eval_step(state.model,
                          (torch.from_numpy(xb[rows_of]).to(dev),
                           torch.from_numpy(yb[rows_of]).long().to(dev)))
            correct += float(m["correct"])
            total += float(m["count"])
        timer(include_in_total=False)       # DAWNBench: evaluation excluded
        row = {"epoch": epoch, "lr": schedule(epoch * steps_per_epoch),
               "train loss": train_loss, "train time": train_time,
               "test acc": correct / total, "total time": timer.total_time}
        rows.append(row)
        if rank == 0:
            table.append(row)
            tsv.append(row)
            # Rewritten every epoch, so that a killed run leaves its curve.
            tsv.write(args.tsv)
    if rank == 0:
        log(f"TSV log -> {args.tsv}")
    if not all(math.isfinite(r["train loss"]) for r in rows):
        raise RuntimeError("non-finite training loss: "
                           f"{[r['train loss'] for r in rows]}")
    return {"rows": rows, "steps": count}


def run(argv, group, dev) -> dict:
    return train(build_parser().parse_args(argv), group, dev)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    common.run_ranks(run, argv, build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
