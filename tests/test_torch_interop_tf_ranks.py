"""The port's TensorFlow front end across two gloo ranks, one process
each: ``broadcast_variables`` gives every rank rank 0's variables,
``DistributedGradientTape`` over the dense exchange returns the mean of
the ranks' gradients, and the Keras metric average is the mean of the
ranks' logs. Only the ranks import TensorFlow."""

import importlib.util
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

if importlib.util.find_spec("tensorflow") is None \
        or importlib.util.find_spec("keras") is None:
    pytest.skip("tensorflow and keras are optional", allow_module_level=True)

WORLD = 2
TIMEOUT_S = 180
DENSE = {"compressor": "none", "memory": "none", "communicator": "allreduce"}


def _worker(rank, init_file, out):
    import tensorflow as tf

    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.interop import keras as port_keras
    from grace_tpu_torch.interop.tensorflow import (DistributedGradientTape,
                                                    broadcast_variables)
    from grace_tpu_torch.parallel import init_process_group

    group, _ = init_process_group("cpu", rank=rank, world_size=WORLD,
                                  init_method=f"file://{init_file}")
    torch.set_num_threads(1)
    try:
        res = {}
        v = tf.Variable(np.full((2, 3), 10.0 * (rank + 1), np.float32))
        w = tf.Variable(np.arange(4, dtype=np.float32) + rank)
        broadcast_variables([v, w], root_rank=0, group=group)
        res["v"], res["w"] = v.numpy(), w.numpy()
        c = np.random.default_rng(rank).standard_normal(5).astype(
            np.float32)
        x = tf.Variable(np.ones(5, np.float32))
        with tf.GradientTape() as tape:
            loss = tf.reduce_sum(x * tf.constant(c))
        grc = grace_from_params(DENSE, group=group)
        res["grad"] = DistributedGradientTape(
            tape, grc, group=group, device="cpu").gradient(loss, x).numpy()
        res["c"] = c
        logs = {"loss": float(rank + 1), "accuracy": 0.25 * rank,
                "note": "kept"}
        port_keras.MetricAverageCallback(group=group)._average(logs)
        res["logs"] = logs
        torch.save(res, out.format(rank))
    finally:
        torch.distributed.destroy_process_group()


def test_two_gloo_ranks_broadcast_and_mean(tmp_path):
    out = str(tmp_path / "rank{}.pt")
    ctx = mp.start_processes(_worker, args=(str(tmp_path / "store"), out),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"two TF ranks did not finish in {TIMEOUT_S} s")
    res = [torch.load(out.format(r), weights_only=False)
           for r in range(WORLD)]
    mean = np.mean([r["c"] for r in res], axis=0, dtype=np.float32)
    for r in res:
        np.testing.assert_array_equal(r["v"], np.full((2, 3), 10.0))
        np.testing.assert_array_equal(r["w"], np.arange(4.0))
        np.testing.assert_allclose(r["grad"], mean, rtol=1e-6)
        assert r["logs"] == {"loss": 1.5, "accuracy": 0.125, "note": "kept"}
    np.testing.assert_array_equal(res[0]["grad"], res[1]["grad"])
