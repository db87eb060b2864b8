"""The port's flagship example, ``grace_tpu_torch.examples.mnist_lenet``,
against the repository's ``examples/mnist_lenet.py`` on the CPU.

Two gloo ranks run the example's own ``train`` (``--synthetic``, 1,536
training digits, the global batch of 512: three steps of Top-K 1% chunk +
residual over the flat buffer, SGD lr 0.01 momentum 0.9, seed 42) and the
JAX example's step runs on a two-device mesh over the same digits, its
init from ``lenet.init(key(42))`` (the port's ``LeNet(seed=42)`` draws it,
normals within 4 ulps). Held within ``rtol=1e-4, atol=1e-5`` (the reduced
ResNet steps' bound, ``tests/test_torch_mnist.py``): the three step
losses, the parameters and every rank's residual after the last step, and
the epoch's test accuracy (each rank's share of every test batch averaged
over the group, as the JAX mesh averages). The checkpoint each rank saved
restores into ``mnist_lenet.build``'s fresh state with the digest the
example printed, and the synthetic digits equal the JAX example's bit for
bit.
"""

import functools
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, TRAIN, BATCH, SEED, LR = 2, 1536, 512, 42, 0.01
RTOL, ATOL = 1e-4, 1e-5
TIMEOUT_S = 300
ARGV = ["--device", "cpu", "--synthetic", "--train-size", str(TRAIN),
        "--epochs", "1", "--compressor", "topk", "--topk-algorithm",
        "chunk", "--memory", "residual"]


def _jax_common():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import common
    return common


def _worker(rank, world, init_file, ckpt_dir, out_path):
    import torch.distributed as dist

    from grace_tpu_torch.checkpoint import Checkpointer
    from grace_tpu_torch.examples import mnist_lenet
    from grace_tpu_torch.parallel import init_process_group
    from grace_tpu_torch.resilience import state_digest

    torch.set_num_threads(1)
    group, _ = init_process_group("cpu", rank=rank, world_size=world,
                                  init_method=f"file://{init_file}")
    try:
        args = mnist_lenet.build_parser().parse_args(
            ARGV + ["--ckpt-dir", ckpt_dir])
        res = mnist_lenet.train(args, group, "cpu", log=lambda *a: None)
        state = res["state"]
        out = {"losses": np.array(res["losses"]),
               "accs": np.array(res["accs"]), "digest": res["digest"]}
        for name, p in state.model.named_parameters():
            out[f"param/{name}"] = p.detach().numpy().copy()
        for j, m in enumerate(state.grace.mem):
            out[f"mem/{j}"] = m.numpy().copy()
        dist.barrier(group)
        _, fresh, _, _ = mnist_lenet.build(args, group, "cpu")
        out["restored"] = state_digest(
            Checkpointer(ckpt_dir, group=group).restore(fresh))
    finally:
        dist.destroy_process_group()
    np.savez(out_path.format(rank=rank), **out)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mnist_lenet"))
    out_path = f"{tmp}/rank{{rank}}.npz"
    ctx = mp.start_processes(
        _worker, args=(WORLD, f"{tmp}/store", f"{tmp}/ckpt", out_path),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{WORLD}-rank gloo run did not finish in "
                        f"{TIMEOUT_S} s")
    results = []
    for r in range(WORLD):
        with np.load(out_path.format(rank=r)) as f:
            results.append({k: f[k] for k in f.files})
    return results


@functools.cache
def _jax_run():
    """The JAX example's loop for one epoch on a WORLD-device mesh: the
    step losses, the final parameters and residuals, the test accuracy."""
    import argparse

    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from grace_tpu import grace_from_params
    from grace_tpu.models import lenet
    from grace_tpu.train import (init_stateful_train_state, make_eval_step,
                                 make_stateful_train_step)

    common = _jax_common()
    parser = argparse.ArgumentParser()
    common.add_grace_args(parser)
    args = parser.parse_args(ARGV[7:])     # the GRACE flags
    x_train, y_train = common.synthetic_mnist(TRAIN, SEED)
    x_test, y_test = common.synthetic_mnist(4096, SEED + 1)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    grace = grace_from_params(common.grace_params_from_args(args))
    optimizer = optax.chain(grace.transform(seed=SEED),
                            optax.sgd(LR, momentum=0.9))
    params, mstate = lenet.init(jax.random.key(SEED))

    def loss_fn(params, mstate, batch):
        logits, new_mstate = lenet.apply(params, mstate, batch[0])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, batch[1]).mean(), new_mstate

    def metric_fn(ps, batch):
        logits, _ = lenet.apply(ps[0], ps[1], batch[0])
        return {"acc": jnp.mean(jnp.argmax(logits, -1) == batch[1])}

    step = make_stateful_train_step(loss_fn, optimizer, mesh, donate=False)
    eval_step = make_eval_step(metric_fn, mesh)
    ts = init_stateful_train_state(params, mstate, optimizer, mesh)
    losses = []
    for xb, yb in common.batches(x_train, y_train, BATCH, shuffle=True,
                                 seed=SEED + 1):
        ts, loss = step(ts, (jnp.asarray(xb), jnp.asarray(yb)))
        losses.append(float(loss))
    accs = [float(eval_step((ts.params, ts.model_state),
                            (jnp.asarray(xb), jnp.asarray(yb)))["acc"])
            for xb, yb in common.batches(x_test, y_test, BATCH,
                                         shuffle=False, seed=0)]
    final = {".".join(str(q.key) for q in path): np.asarray(v)
             for path, v in
             jax.tree_util.tree_flatten_with_path(ts.params)[0]}
    mem = [np.asarray(m) for m in ts.opt_state[0].mem]
    return losses, final, mem, float(np.mean(accs))


def test_synthetic_digits_equal_the_jax_example():
    from grace_tpu_torch.examples.common import synthetic_mnist

    want = _jax_common().synthetic_mnist(TRAIN, SEED)
    for got, w in zip(synthetic_mnist(TRAIN, SEED), want):
        np.testing.assert_array_equal(got, w)


def test_steps_match_the_jax_example(port):
    losses, params, mem, _ = _jax_run()
    assert len(losses) == TRAIN // BATCH
    for r in range(WORLD):
        np.testing.assert_allclose(port[r]["losses"], losses, rtol=RTOL)
        for name, v in params.items():
            np.testing.assert_allclose(port[r][f"param/{name}"], v,
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        assert len(mem) == 1                       # the flat buffer
        np.testing.assert_allclose(
            port[r]["mem/0"].reshape(mem[0][r].shape), mem[0][r],
            rtol=RTOL, atol=ATOL)


def test_evaluation_averages_the_ranks_shares_as_the_mesh(port):
    acc = _jax_run()[3]
    for r in range(WORLD):
        np.testing.assert_allclose(port[r]["accs"], [acc], rtol=RTOL)


def test_checkpoint_restores_the_printed_digest(port):
    """Each rank's state (its own residuals) comes back from the
    checkpoint's replicated and per-rank files with its digest."""
    for r in range(WORLD):
        assert str(port[r]["restored"]) == str(port[r]["digest"])
