"""Real-MNIST convergence: LeNet on the bundled 10,000-image set.

The port's twin of the repository's ``examples/mnist10k_lenet.py``, with
the same flags and defaults: 40 epochs, a global batch of 256, SGD at lr
0.02 with momentum 0.9, seed 42, ``--fusion flat``, and a ``--tsv`` log.
The data is the deterministic 8,000/2,000 split of the bundled t10k files
(``grace_tpu_torch.data``); every rank shuffles the train split with
``default_rng(seed + epoch)`` and takes its contiguous ``B/W`` rows of each
global batch, which ``data.prefetch_to_device`` copies to the device two
batches ahead of the step (``--prefetch``), as the JAX example does. The
2,000 test images are evaluated at the end of each epoch, each rank on its
contiguous share, the counts averaged over the group. The GRACE flags are
``examples.common``'s, the JAX examples' full set.

One rank on the card (NCCL):

    python -m grace_tpu_torch.examples.mnist10k_lenet --compressor topk \\
        --topk-algorithm chunk --memory residual --tsv run.tsv

Eight gloo ranks on the CPU, spawned by the script itself:

    python -m grace_tpu_torch.examples.mnist10k_lenet --device cpu \\
        --nproc 8 --compressor topk --topk-algorithm chunk \\
        --memory residual --tsv run.tsv
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from grace_tpu_torch import grace_from_params
from grace_tpu_torch.data import (BUNDLED_MNIST_DIR, batches, load_mnist_auto,
                                  prefetch_to_device)
from grace_tpu_torch.examples.common import (add_grace_args,
                                             grace_params_from_args)
from grace_tpu_torch.models.lenet import LeNet
from grace_tpu_torch.parallel import init_process_group, resolve_device
from grace_tpu_torch.train import (init_train_state, make_eval_step,
                                   make_train_step, set_lr)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    add_grace_args(parser)
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--batch-size", type=int, default=256,
                        help="global batch (split across the ranks)")
    parser.add_argument("--lr", type=float, default=0.02)
    parser.add_argument("--cosine-lr", action="store_true",
                        help="cosine-decay the lr to 0 over the run")
    parser.add_argument("--sgd-momentum", type=float, default=0.9,
                        help="heavy-ball momentum of the outer SGD (0: none)")
    parser.add_argument("--data-dir", default=BUNDLED_MNIST_DIR,
                        help="directory with the MNIST t10k idx(.gz) files")
    parser.add_argument("--tsv", default=None,
                        help="write the per-epoch log (epoch, train_loss, "
                             "test_acc) here")
    parser.add_argument("--device", default="cuda",
                        help="cuda (NCCL, one card a rank) or cpu (gloo)")
    parser.add_argument("--nproc", type=int, default=1,
                        help="ranks to spawn, one process each")
    parser.add_argument("--prefetch", type=int, default=2,
                        help="batches copied to the device ahead of the step "
                             "(data.prefetch_to_device); 0: a blocking copy "
                             "a step")
    return parser


def device_batches(host, dev, prefetch: int):
    """The host batches ``host`` on ``dev``: through ``prefetch_to_device``
    ``prefetch`` batches ahead, or (``prefetch`` 0) one blocking copy each
    as it is pulled."""
    if prefetch:
        return prefetch_to_device(host, dev, size=prefetch)
    return ((torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev))
            for xb, yb in host)


def _loss_fn(model, batch):
    x, y = batch
    return F.cross_entropy(model(x), y)


def _metric_fn(model, batch):
    x, y = batch
    correct = (model(x).argmax(-1) == y).sum()
    return {"correct": correct, "count": torch.tensor(y.numel(),
                                                      device=y.device)}


def _commit() -> str:
    try:
        sha = subprocess.run(["git", "rev-parse", "HEAD"], cwd=_REPO_ROOT,
                             capture_output=True, text=True, timeout=10)
        dirty = subprocess.run(["git", "status", "--porcelain", "--",
                                "grace_tpu_torch"], cwd=_REPO_ROOT,
                               capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    if sha.returncode != 0:
        return "unknown"
    return sha.stdout.strip() + (" with uncommitted changes to "
                                 "grace_tpu_torch" if dirty.stdout.strip()
                                 else "")


def train(args, group, device, log=print) -> dict:
    """Train LeNet under ``args`` in the process group ``group`` on
    ``device``; this rank's share of the run. Returns the curve (``accs``,
    the test accuracy of each epoch, and ``test_acc``, the last), the step
    count, the wall seconds, and the last train state, step function and local
    batch (for a caller that profiles one more step)."""
    dev = resolve_device(device)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if args.batch_size % world:
        raise ValueError(f"--batch-size {args.batch_size} does not split "
                         f"over {world} ranks")
    local = args.batch_size // world
    x_train, y_train, x_test, y_test = load_mnist_auto(args.data_dir)
    grace = grace_from_params(grace_params_from_args(args), group=group)
    tx = grace.transform(seed=args.seed)
    model = LeNet(device=dev, seed=args.seed)
    opt = torch.optim.SGD(model.parameters(), lr=args.lr,
                          momentum=args.sgd_momentum)
    state = init_train_state(model, tx, opt, group)
    step = make_train_step(_loss_fn, tx, group)
    eval_step = make_eval_step(_metric_fn, group)
    shares = np.array_split(np.arange(len(x_test)), world)[rank]
    test = (torch.from_numpy(x_test[shares]).to(dev),
            torch.from_numpy(y_test[shares]).long().to(dev))
    steps_per_epoch = max(1, len(x_train) // args.batch_size)
    total_steps = args.epochs * steps_per_epoch

    def cosine(count):                    # optax.cosine_decay_schedule
        frac = min(count, total_steps) / total_steps
        return args.lr * 0.5 * (1 + math.cos(math.pi * frac))

    rows, accs, steps, batch = ["epoch\ttrain_loss\ttest_acc"], [], 0, None
    t0 = time.perf_counter()
    for epoch in range(1, args.epochs + 1):
        losses = []
        rows_of = slice(rank * local, (rank + 1) * local)
        host = ((xb[rows_of], yb[rows_of].astype(np.int64))
                for xb, yb in batches(x_train, y_train, args.batch_size,
                                      shuffle=True, seed=args.seed + epoch))
        for batch in device_batches(host, dev, args.prefetch):
            if args.cosine_lr:
                set_lr(opt, cosine, steps)
            state, loss = step(state, batch)
            losses.append(float(loss))
            steps += 1
        metrics = eval_step(state.model, test)
        test_acc = float(metrics["correct"] / metrics["count"])
        train_loss = sum(losses) / len(losses)
        accs.append(test_acc)
        rows.append(f"{epoch}\t{train_loss:.4f}\t{test_acc:.4f}")
        if rank == 0:
            log(f"epoch {epoch:3d}  train loss {train_loss:.4f}  test acc "
                f"{test_acc:.4f}  ({time.perf_counter() - t0:.1f} s)")
    seconds = time.perf_counter() - t0
    if args.tsv and rank == 0:
        data = os.path.relpath(args.data_dir, _REPO_ROOT)
        header = {"data": f"real:mnist({data})",
                  "config": json.dumps(grace_params_from_args(args)),
                  "epochs": args.epochs, "batch_size": args.batch_size,
                  "lr": args.lr, "sgd_momentum": args.sgd_momentum,
                  "cosine_lr": args.cosine_lr, "seed": args.seed,
                  "world": world, "backend": dist.get_backend(group),
                  "device": (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu"),
                  "torch": torch.__version__, "commit": _commit(),
                  "seconds": f"{seconds:.1f}"}
        os.makedirs(os.path.dirname(os.path.abspath(args.tsv)),
                    exist_ok=True)
        with open(args.tsv, "w") as f:
            f.write("\n".join([f"# {k}: {v}" for k, v in header.items()]
                              + rows) + "\n")
        log(f"log -> {args.tsv}")
    return {"test_acc": accs[-1] if accs else 0.0, "accs": accs,
            "steps": steps, "seconds": seconds,
            "state": state, "step": step, "batch": batch}


def _worker(rank, world, init_method, argv, result_path):
    args = build_parser().parse_args(argv)
    if args.device == "cpu":
        # The ranks share the host's cores; more threads a rank than its
        # share only contend.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        device = "cpu"
    else:
        device = f"cuda:{rank}"
    group, dev = init_process_group(device, rank=rank, world_size=world,
                                    init_method=init_method)
    try:
        res = train(args, group, dev)
        if rank == 0:
            with open(result_path, "w") as f:
                json.dump({k: res[k] for k in ("test_acc", "accs", "steps",
                                               "seconds")}, f)
    finally:
        dist.destroy_process_group()


def run(argv=None) -> float:
    """Parse ``argv``, train, and return the final test accuracy. With
    ``--nproc N`` > 1 the ranks are N spawned processes; otherwise this
    process is the one rank."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.nproc > 1:
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as tmp:
            result = os.path.join(tmp, "result.json")
            mp.start_processes(
                _worker, args=(args.nproc, f"file://{tmp}/store",
                               argv, result),
                nprocs=args.nproc, join=True, start_method="spawn")
            with open(result) as f:
                return json.load(f)["test_acc"]
    group, dev = init_process_group(args.device)
    try:
        return train(args, group, dev)["test_acc"]
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    print(f"final test accuracy: {run():.4f}")
