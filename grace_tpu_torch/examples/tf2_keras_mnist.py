"""Keras MNIST with the port's ``DistributedOptimizer``.

The port's twin of the repository's ``examples/tf2_keras_mnist.py`` (the
reference's tensorflow2_keras_mnist.py): ``model.fit`` with a
grace-wrapped Keras optimizer (the TF 1-bit/signSGD path is
``--compressor onebit --memory residual`` or ``--compressor signsgd``)
and the reference's callbacks: the initial-state broadcast, the metric
average over the ranks and the learning-rate warmup. TensorFlow runs on
the host; the exchange runs on ``--device``. Each rank takes every W-th
sample of the set.

Two gloo ranks on the CPU:

    python -m grace_tpu_torch.examples.tf2_keras_mnist --device cpu \\
        --nproc 2 --epochs 3 --compressor onebit --memory residual \\
        --communicator allgather
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch.distributed as dist

from grace_tpu_torch.examples import common


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    common.add_grace_args(parser)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--warmup-epochs", type=int, default=3)
    parser.add_argument("--train-size", type=int, default=8192)
    parser.add_argument("--data-dir", default=None,
                        help="MNIST idx directory (default: synthetic)")
    parser.add_argument("--ckpt", default=None,
                        help="save the trained model here (.keras); reload "
                             "with grace_tpu_torch.interop.keras.load_model")
    common.add_rank_args(parser)
    return parser


def train(argv, group, dev) -> dict:
    """Train under ``argv`` as this rank of ``group``; the fit history."""
    import keras

    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.data import load_mnist_idx
    from grace_tpu_torch.interop.keras import (
        BroadcastGlobalVariablesCallback, DistributedOptimizer,
        LearningRateWarmupCallback, MetricAverageCallback)
    from grace_tpu_torch.utils import rank_zero_print

    args = build_parser().parse_args(argv)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    grc = grace_from_params(common.grace_params_from_args(args), group=group)

    if args.data_dir:
        x, y = load_mnist_idx(args.data_dir, train=True)
    else:
        x, y = common.synthetic_mnist(args.train_size, seed=args.seed)
    x, y = x[rank::world], y[rank::world]

    keras.utils.set_random_seed(args.seed)
    model = keras.Sequential([
        keras.layers.Conv2D(32, 3, activation="relu"),
        keras.layers.MaxPooling2D(),
        keras.layers.Conv2D(64, 3, activation="relu"),
        keras.layers.MaxPooling2D(),
        keras.layers.Flatten(),
        keras.layers.Dense(128, activation="relu"),
        keras.layers.Dense(10),
    ])
    opt = DistributedOptimizer(keras.optimizers.SGD(args.lr), grc,
                               group=group, seed=args.seed, device=dev)
    model.compile(
        optimizer=opt,
        loss=keras.losses.SparseCategoricalCrossentropy(from_logits=True),
        metrics=["accuracy"])

    callbacks = [
        BroadcastGlobalVariablesCallback(root_rank=0, group=group),
        MetricAverageCallback(group=group),
        LearningRateWarmupCallback(world_size=world,
                                   warmup_epochs=args.warmup_epochs,
                                   verbose=rank == 0),
    ]
    hist = model.fit(x.astype(np.float32), y.astype(np.int32),
                     batch_size=args.batch_size, epochs=args.epochs,
                     callbacks=callbacks, verbose=2 if rank == 0 else 0)

    if args.ckpt and rank == 0:
        model.save(args.ckpt)
        rank_zero_print(f"model saved to {args.ckpt}")
    return hist.history


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    common.run_ranks(train, argv, build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
