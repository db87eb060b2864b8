"""MNIST LeNet with compressed data-parallel training: the flagship example.

The port's twin of the repository's ``examples/mnist_lenet.py``, with its
flags and defaults: LeNet on the bundled MNIST set (the 10,000 t10k images
split 8,000/2,000, ``data.load_mnist_auto``) or ``--synthetic`` digits,
every GRACE flag of ``examples.common`` (default: no compression, the flat
buffer), 3 epochs, a global batch of 512, SGD at lr 0.01 with momentum
0.9, seed 42. It prints the wire cost (``utils.wire_report``), a
``TableLogger`` row an epoch (train loss, epoch seconds, test accuracy:
each rank evaluates its share of every test batch and the group averages,
as the JAX example's mesh does), the kernel launches of the run, and with
``--ckpt-dir`` saves the train state (GRACE state included) through
``checkpoint.Checkpointer`` and prints its digest
(``resilience.retune.state_digest``), which a restore into
:func:`build`'s state reproduces.

One rank on the card (NCCL):

    python -m grace_tpu_torch.examples.mnist_lenet --compressor topk \\
        --topk-algorithm chunk --memory residual --ckpt-dir /tmp/ckpt

Two gloo ranks on the CPU, spawned by the script itself:

    python -m grace_tpu_torch.examples.mnist_lenet --device cpu --nproc 2 \\
        --epochs 2 --compressor topk --compress-ratio 0.1 --memory residual
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from grace_tpu_torch import grace_from_params, ops
from grace_tpu_torch.data import BUNDLED_MNIST_DIR, batches, load_mnist_auto
from grace_tpu_torch.examples.common import (add_grace_args, add_rank_args,
                                             grace_params_from_args,
                                             run_ranks, synthetic_mnist)
from grace_tpu_torch.models.lenet import LeNet
from grace_tpu_torch.parallel import resolve_device
from grace_tpu_torch.train import (init_train_state, make_eval_step,
                                   make_train_step)
from grace_tpu_torch.utils import (TableLogger, Timer, rank_zero_print,
                                   wire_report)

MOMENTUM = 0.9                    # the JAX example's SGD momentum
SYNTHETIC_TEST_SIZE = 4096        # the JAX example's synthetic test split


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    add_grace_args(parser)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=512,
                        help="global batch (split across the ranks)")
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--train-size", type=int, default=16384,
                        help="synthetic dataset size (with --synthetic)")
    parser.add_argument("--data-dir", default=BUNDLED_MNIST_DIR,
                        help="directory with MNIST idx files (default: the "
                             "bundled 10k-image set, split 80/20)")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic digits instead of the "
                             "bundled real MNIST images")
    parser.add_argument("--ckpt-dir", default=None,
                        help="save a checkpoint here after training")
    add_rank_args(parser)
    return parser


def load_data(args):
    """``(x_train, y_train, x_test, y_test)``: the bundled split, or the
    synthetic digits of the JAX example (``--synthetic``)."""
    if args.synthetic or not args.data_dir:
        x_train, y_train = synthetic_mnist(args.train_size, args.seed)
        x_test, y_test = synthetic_mnist(SYNTHETIC_TEST_SIZE, args.seed + 1)
        return x_train, y_train, x_test, y_test
    return load_mnist_auto(args.data_dir)


def loss_fn(model, batch):
    x, y = batch
    return F.cross_entropy(model(x), y)


def metric_fn(model, batch):
    x, y = batch
    logits = model(x)
    return {"acc": (logits.argmax(-1) == y).float().mean(),
            "loss": F.cross_entropy(logits, y)}


def build(args, group, dev):
    """``(grace, state, step, eval_step)`` of a fresh run: the GRACE
    bundle, the train state (LeNet from ``--seed``, SGD with momentum
    0.9, the GRACE state) and the two step functions. A checkpoint of the
    run restores into this state."""
    grace = grace_from_params(grace_params_from_args(args), group=group)
    tx = grace.transform(seed=args.seed)
    model = LeNet(device=dev, seed=args.seed)
    opt = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=MOMENTUM)
    state = init_train_state(model, tx, opt, group)
    return (grace, state, make_train_step(loss_fn, tx, group),
            make_eval_step(metric_fn, group))


def _rank_batches(x, y, args, rank, world, dev, *, shuffle, seed):
    """This rank's contiguous ``B/W`` rows of each global batch, on
    ``dev``."""
    local = args.batch_size // world
    rows = slice(rank * local, (rank + 1) * local)
    for xb, yb in batches(x, y, args.batch_size, shuffle=shuffle, seed=seed):
        yield (torch.from_numpy(xb[rows]).to(dev),
               torch.from_numpy(yb[rows].astype(np.int64)).to(dev))


def train(args, group, device, log=rank_zero_print) -> dict:
    """Train under ``args`` in ``group`` on ``device``: this rank's
    results (``losses``, the per-step losses; ``accs``, the test accuracy
    of each epoch; ``state``, the last train state; ``digest``, the saved
    checkpoint's, with ``--ckpt-dir``)."""
    dev = resolve_device(device)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} must divide by "
                         f"the {world} ranks")
    x_train, y_train, x_test, y_test = load_data(args)
    if not (args.synthetic or not args.data_dir):
        log(f"real MNIST from {args.data_dir}: {len(x_train)} train / "
            f"{len(x_test)} test")
    if len(x_train) < args.batch_size or len(x_test) < args.batch_size:
        raise SystemExit(f"--batch-size {args.batch_size} exceeds dataset "
                         f"split sizes ({len(x_train)} train / "
                         f"{len(x_test)} test)")
    grace, state, step, eval_step = build(args, group, dev)
    log("wire cost:", wire_report(grace.compressor,
                                  dict(state.model.named_parameters())))
    table = TableLogger()
    timer = Timer(sync=(torch.cuda.synchronize if dev.type == "cuda"
                        else None))
    n_eval = len(x_test) - (len(x_test) % args.batch_size)
    all_losses, accs = [], []
    for epoch in range(1, args.epochs + 1):
        losses = []
        for batch in _rank_batches(x_train, y_train, args, rank, world, dev,
                                   shuffle=True, seed=args.seed + epoch):
            state, loss = step(state, batch)
            losses.append(loss)
        losses = [float(v) for v in losses]
        all_losses += losses
        epoch_time = timer()
        accs_e = [eval_step(state.model, batch)["acc"]
                  for batch in _rank_batches(
                      x_test[:n_eval], y_test[:n_eval], args, rank, world,
                      dev, shuffle=False, seed=0)]
        test_acc = float(torch.stack(accs_e).mean())
        accs.append(test_acc)
        if rank == 0:
            table.append({"epoch": epoch,
                          "train loss": float(np.mean(losses)),
                          "epoch time": epoch_time, "test acc": test_acc})
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    log(f"kernel launches: {json.dumps(launches, sort_keys=True)}")
    digest = None
    if args.ckpt_dir:
        from grace_tpu_torch.checkpoint import Checkpointer
        from grace_tpu_torch.resilience.retune import state_digest

        Checkpointer(args.ckpt_dir, group=group).save(args.epochs, state)
        digest = state_digest(state)
        log(f"checkpoint (incl. compression state) -> {args.ckpt_dir} "
            f"(step {args.epochs}, digest {digest})")
    return {"losses": all_losses, "accs": accs, "state": state,
            "digest": digest, "launches": launches}


def _main(argv, group, dev, result_path=None):
    res = train(build_parser().parse_args(argv), group, dev)
    if result_path and dist.get_rank(group) == 0:
        with open(result_path, "w") as f:
            json.dump({k: res[k] for k in ("losses", "accs", "digest")}, f)
    return res


def run(argv=None) -> dict:
    """Parse ``argv`` and train; rank 0's losses, accuracies and digest.
    With ``--nproc N`` > 1 the ranks are N spawned processes; otherwise
    this process is the one rank."""
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
    res = run()
    rank_zero_print(f"final test accuracy: {res['accs'][-1]:.4f}")
