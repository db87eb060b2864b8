"""The port's three TensorFlow examples, each ``main`` at a tiny size on
one rank with ``--device cpu``: the tape example trains and checkpoints,
the Keras example fits with its callbacks and saves, the benchmark times
its iterations."""

import pytest

tf = pytest.importorskip("tensorflow")
keras = pytest.importorskip("keras")


def test_tf2_mnist_main_trains(capsys, tmp_path):
    from grace_tpu_torch.examples import tf2_mnist
    tf2_mnist.main(["--device", "cpu", "--steps", "11", "--train-size",
                    "256", "--batch-size", "32", "--compressor", "topk",
                    "--compress-ratio", "0.1", "--memory", "residual",
                    "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "step     0  loss" in out and "step    10  loss" in out
    assert "checkpoint saved to" in out
    assert list((tmp_path / "ck").glob("ckpt-1*"))


def test_tf2_keras_mnist_main_fits(capsys, tmp_path):
    from grace_tpu_torch.examples import tf2_keras_mnist
    ckpt = tmp_path / "m.keras"
    tf2_keras_mnist.main(["--device", "cpu", "--epochs", "1",
                          "--train-size", "256", "--batch-size", "64",
                          "--compressor", "onebit", "--memory", "residual",
                          "--warmup-epochs", "1", "--ckpt", str(ckpt)])
    out = capsys.readouterr().out
    assert "LearningRateWarmup: epoch 0" in out
    assert f"model saved to {ckpt}" in out and ckpt.exists()


def test_tf2_synthetic_benchmark_main_times(capsys):
    from grace_tpu_torch.examples import tf2_synthetic_benchmark
    tf2_synthetic_benchmark.main(["--device", "cpu", "--model", "small",
                                  "--batch-size", "4", "--num-iters", "2",
                                  "--num-batches-per-iter", "1",
                                  "--num-warmup-batches", "1"])
    out = capsys.readouterr().out
    assert "iter 0:" in out and "iter 1:" in out
    assert "imgs/sec per worker:" in out
