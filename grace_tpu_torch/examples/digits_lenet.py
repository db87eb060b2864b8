"""Real-data convergence on the UCI digits: LeNet on scikit-learn's bundled
1,797 scanned 8×8 digits, upscaled to 28×28.

The port's twin of the repository's ``examples/digits_lenet.py``, with the
same flags and defaults: 60 epochs, a global batch of 128, SGD at lr 0.02
with momentum 0.9, seed 42, every GRACE flag of ``examples.common``, and a
``--tsv`` log whose header is ``run_provenance(data=
"real:sklearn-uci-digits", ...)``. The split is ``data.digits_dataset``'s
fixed-seed 1,437/360; every rank shuffles the train split with
``default_rng(seed + epoch)``, takes its contiguous ``B/W`` rows of each
global batch, and ``data.prefetch_to_device`` copies them to the device two
batches ahead of the step. Every rank evaluates the whole 360-image test
split after each epoch, as the JAX example does. Needs scikit-learn.

Eight gloo ranks on the CPU, spawned by the script itself:

    python -m grace_tpu_torch.examples.digits_lenet --device cpu --nproc 8 \\
        --compressor topk --compress-ratio 0.01 --memory residual \\
        --tsv run.tsv

One rank on the card (NCCL): drop ``--device cpu --nproc 8``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from grace_tpu_torch import grace_from_params
from grace_tpu_torch.data import batches, digits_dataset, prefetch_to_device
from grace_tpu_torch.examples.common import (add_grace_args, add_rank_args,
                                             grace_params_from_args,
                                             grace_provenance, run_ranks)
from grace_tpu_torch.examples.mnist10k_lenet import _loss_fn
from grace_tpu_torch.models.lenet import LeNet
from grace_tpu_torch.parallel import resolve_device
from grace_tpu_torch.train import init_train_state, make_train_step
from grace_tpu_torch.utils import rank_zero_print, run_provenance, wire_report

MOMENTUM = 0.9                    # the JAX example's fixed SGD momentum


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    add_grace_args(parser)
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--batch-size", type=int, default=128,
                        help="global batch (split across the ranks)")
    parser.add_argument("--lr", type=float, default=0.02)
    parser.add_argument("--tsv", default=None,
                        help="write the per-epoch log (epoch, train_loss, "
                             "test_acc) here")
    add_rank_args(parser)
    return parser


def train(args, group, device, log=rank_zero_print) -> dict:
    """Train LeNet on the digits under ``args`` in ``group`` on ``device``;
    returns the curve (``accs``, ``losses``), ``test_acc`` (the last) and
    the step count."""
    dev = resolve_device(device)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if args.batch_size % world:
        raise ValueError(f"--batch-size {args.batch_size} does not split "
                         f"over {world} ranks")
    local = args.batch_size // world
    train_set, test_set = digits_dataset(train=True), digits_dataset(
        train=False)
    x_train, y_train = train_set.normalize(train_set.images), train_set.labels
    # The test split under the train split's statistics (digits_dataset
    # gives both splits the train split's).
    x_test = torch.from_numpy(test_set.normalize(test_set.images)).to(dev)
    y_test = torch.from_numpy(test_set.labels).long().to(dev)

    grace = grace_from_params(grace_params_from_args(args), group=group)
    tx = grace.transform(seed=args.seed)
    model = LeNet(device=dev, seed=args.seed)
    log("wire cost:", wire_report(grace.compressor,
                                  dict(model.named_parameters())))
    opt = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=MOMENTUM)
    state = init_train_state(model, tx, opt, group)
    step = make_train_step(_loss_fn, tx, group)

    rows, accs, losses_by_epoch, steps = ["epoch\ttrain_loss\ttest_acc"], \
        [], [], 0
    t0 = time.perf_counter()
    for epoch in range(1, args.epochs + 1):
        losses = []
        rows_of = slice(rank * local, (rank + 1) * local)
        host = ((xb[rows_of], yb[rows_of].astype(np.int64))
                for xb, yb in batches(x_train, y_train, args.batch_size,
                                      shuffle=True, seed=args.seed + epoch))
        for batch in prefetch_to_device(host, dev, size=2):
            state, loss = step(state, batch)
            losses.append(float(loss))
            steps += 1
        with torch.no_grad():
            test_acc = float((state.model(x_test).argmax(-1) == y_test)
                             .float().mean())
        train_loss = sum(losses) / len(losses)
        accs.append(test_acc)
        losses_by_epoch.append(train_loss)
        rows.append(f"{epoch}\t{train_loss:.4f}\t{test_acc:.4f}")
        log(f"epoch {epoch:3d}  train loss {train_loss:.4f}  test acc "
            f"{test_acc:.4f}  ({time.perf_counter() - t0:.1f} s)")
    seconds = time.perf_counter() - t0
    if args.tsv and rank == 0:
        prov = run_provenance(
            data="real:sklearn-uci-digits", **grace_provenance(args),
            config=json.dumps(grace_params_from_args(args)),
            epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
            sgd_momentum=MOMENTUM, seed=args.seed, world=world,
            backend=dist.get_backend(group), torch=torch.__version__,
            seconds=f"{seconds:.1f}")
        os.makedirs(os.path.dirname(os.path.abspath(args.tsv)),
                    exist_ok=True)
        with open(args.tsv, "w") as f:
            f.write("\n".join([f"# {k}: {v}" for k, v in prov.items()]
                              + rows) + "\n")
        log(f"log -> {args.tsv}")
    return {"test_acc": accs[-1] if accs else 0.0, "accs": accs,
            "losses": losses_by_epoch, "steps": steps, "seconds": seconds}


def _main(argv, group, dev, result_path=None):
    res = train(build_parser().parse_args(argv), group, dev)
    if result_path and dist.get_rank(group) == 0:
        with open(result_path, "w") as f:
            json.dump(res, f)
    return res


def run(argv=None) -> dict:
    """Parse ``argv`` and train; returns rank 0's curve. With ``--nproc N``
    > 1 the ranks are N spawned processes; otherwise this process is the
    one rank."""
    import functools
    import tempfile

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "result.json")
        run_ranks(functools.partial(_main, result_path=path), argv, args)
        with open(path) as f:
            return json.load(f)


if __name__ == "__main__":
    rank_zero_print(f"final test accuracy: {run()['test_acc']:.4f}")
