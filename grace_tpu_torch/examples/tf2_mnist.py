"""TF2 MNIST with ``DistributedGradientTape`` over the port's exchange.

The port's twin of the repository's ``examples/tf2_mnist.py`` (the
reference's tensorflow2_mnist.py): a small Keras CNN trained eagerly,
``tape.gradient`` returning the aggregated, compressed-exchanged
gradients of ``grace_tpu_torch.interop.tensorflow``. TensorFlow runs on
the host; the exchange runs on ``--device`` (the card by default). Each
rank takes every W-th sample of the set.

Two gloo ranks on the CPU:

    python -m grace_tpu_torch.examples.tf2_mnist --device cpu --nproc 2 \\
        --steps 200 --compressor topk --compress-ratio 0.1 \\
        --memory residual
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
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--train-size", type=int, default=8192)
    parser.add_argument("--data-dir", default=None,
                        help="MNIST idx directory (default: synthetic)")
    parser.add_argument("--ckpt-dir", default=None,
                        help="rank-0 tf.train.Checkpoint directory")
    common.add_rank_args(parser)
    return parser


def train(argv, group, dev) -> list:
    """Train under ``argv`` as this rank of ``group``; the losses printed
    (every tenth step's)."""
    import tensorflow as tf

    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.data import load_mnist_idx
    from grace_tpu_torch.interop.tensorflow import (DistributedGradientTape,
                                                    broadcast_variables)
    from grace_tpu_torch.utils import rank_zero_print

    args = build_parser().parse_args(argv)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    grc = grace_from_params(common.grace_params_from_args(args), group=group)

    if args.data_dir:
        x, y = load_mnist_idx(args.data_dir, train=True)
    else:
        x, y = common.synthetic_mnist(args.train_size, seed=args.seed)
    x, y = x[rank::world], y[rank::world]
    ds = (tf.data.Dataset.from_tensor_slices(
            (x.astype(np.float32), y.astype(np.int64)))
          .shuffle(8192, seed=args.seed).repeat()
          .batch(args.batch_size, drop_remainder=True))

    # The reference model (conv-pool twice, then an MLP).
    tf.random.set_seed(args.seed)
    model = tf.keras.Sequential([
        tf.keras.layers.Conv2D(32, 3, activation="relu"),
        tf.keras.layers.MaxPooling2D(),
        tf.keras.layers.Conv2D(64, 3, activation="relu"),
        tf.keras.layers.MaxPooling2D(),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(128, activation="relu"),
        tf.keras.layers.Dense(10),
    ])
    loss_fn = tf.keras.losses.SparseCategoricalCrossentropy(from_logits=True)
    opt = tf.keras.optimizers.Adam(args.lr)

    def training_step(images, labels, first_batch):
        with tf.GradientTape() as tape:
            logits = model(images, training=True)
            loss = loss_fn(labels, logits)
        tape = DistributedGradientTape(tape, grc, group=group,
                                       seed=args.seed, device=dev)
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        # After the first step, so the lazily created variables (conv
        # kernels, Adam slots) exist.
        if first_batch:
            broadcast_variables(model.variables, group=group)
            broadcast_variables(opt.variables, group=group)
        return loss

    losses = []
    for step, (images, labels) in enumerate(ds.take(args.steps)):
        loss = training_step(images, labels, step == 0)
        if step % 10 == 0:
            losses.append(float(loss))
            rank_zero_print(f"step {step:5d}  loss {float(loss):.4f}")

    if args.ckpt_dir and rank == 0:
        tf.train.Checkpoint(model=model).save(args.ckpt_dir + "/ckpt")
        rank_zero_print(f"checkpoint saved to {args.ckpt_dir}")
    return losses


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    common.run_ranks(train, argv, build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
