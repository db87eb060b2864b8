"""TF2 synthetic throughput through the port's compressed tape.

The port's twin of the repository's ``examples/tf2_synthetic_benchmark.py``
(the reference's tensorflow2_synthetic_benchmark.py): a Keras model on
random data, img/sec over warm iterations, the gradients exchanged through
``DistributedGradientTape``. TensorFlow runs on the host; the exchange
runs on ``--device``.

One gloo rank on the CPU:

    python -m grace_tpu_torch.examples.tf2_synthetic_benchmark \\
        --device cpu --model small --compressor signsgd --num-iters 3
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from grace_tpu_torch.examples import common


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    common.add_grace_args(parser)
    parser.set_defaults(compressor="signsgd", memory="none",
                        communicator="allgather")
    parser.add_argument("--model", default="small",
                        help="small (3-conv CNN) | resnet50 (keras "
                             "applications, ImageNet shapes)")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-iters", type=int, default=5,
                        help="timed iterations")
    parser.add_argument("--num-batches-per-iter", type=int, default=5)
    parser.add_argument("--num-warmup-batches", type=int, default=2)
    parser.add_argument("--lr", type=float, default=0.01)
    common.add_rank_args(parser)
    return parser


def run(argv, group, dev) -> list:
    """Benchmark under ``argv`` as this rank of ``group``; img/sec of each
    timed iteration."""
    import tensorflow as tf

    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.interop.tensorflow import DistributedGradientTape
    from grace_tpu_torch.utils import rank_zero_print

    args = build_parser().parse_args(argv)
    grc = grace_from_params(common.grace_params_from_args(args), group=group)

    tf.random.set_seed(args.seed)
    if args.model == "resnet50":
        model = tf.keras.applications.ResNet50(weights=None)
        hw, classes = 224, 1000
    else:
        model = tf.keras.Sequential([
            tf.keras.layers.Conv2D(32, 3, activation="relu"),
            tf.keras.layers.MaxPooling2D(),
            tf.keras.layers.Conv2D(64, 3, activation="relu"),
            tf.keras.layers.MaxPooling2D(),
            tf.keras.layers.Conv2D(64, 3, activation="relu"),
            tf.keras.layers.Flatten(),
            tf.keras.layers.Dense(10),
        ])
        hw, classes = 32, 10

    rng = np.random.default_rng(args.seed)
    images = tf.constant(
        rng.standard_normal((args.batch_size, hw, hw, 3)), tf.float32)
    labels = tf.constant(rng.integers(0, classes, args.batch_size), tf.int64)
    loss_fn = tf.keras.losses.SparseCategoricalCrossentropy(from_logits=True)
    opt = tf.keras.optimizers.SGD(args.lr)

    def step():
        with tf.GradientTape() as tape:
            loss = loss_fn(labels, model(images, training=True))
        tape = DistributedGradientTape(tape, grc, group=group,
                                       seed=args.seed, device=dev)
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        return loss

    for _ in range(args.num_warmup_batches):
        step()

    # The reference protocol: mean +- 1.96 sigma over num_iters iterations.
    rates = []
    for it in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            step()
        dt = time.perf_counter() - t0
        rates.append(args.batch_size * args.num_batches_per_iter / dt)
        rank_zero_print(f"iter {it}: {rates[-1]:.1f} imgs/sec")
    rank_zero_print(f"imgs/sec per worker: {np.mean(rates):.1f} "
                    f"+- {1.96 * np.std(rates):.1f}")
    return rates


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    common.run_ranks(run, argv, build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
