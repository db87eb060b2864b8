"""Two ranks of the port over a real gloo group against the JAX package's
``grace_transform`` on a two-device mesh.

Each rank takes its own gradients (numpy, from a seed) through three GRACE
steps, for the Top-K 1% chunk + residual + allgather configuration and for
the dense none + allreduce one. The port's ranks are processes spawned with
``torch.multiprocessing``; JAX is imported inside the test functions only,
so the workers stay light. The JAX side runs its staged path (its
``use_pallas='auto'``); the port runs its fused path (the chunk kernels'
plain versions on the CPU).

Residuals and the dense path's updates must match bit for bit. The Top-K
updates are allowed ``atol=1e-6`` for the order of the aggregate's sum (the
JAX package's own kernel-vs-staged tolerance); they match exactly at W=2.
"""

import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

TOPK1 = {"compressor": "topk", "compress_ratio": 0.01,
         "topk_algorithm": "chunk", "memory": "residual",
         "communicator": "allgather", "fusion": "none"}
DENSE = {"compressor": "none", "memory": "none", "communicator": "allreduce",
         "fusion": "none"}
WORLD, STEPS = 2, 3
# A leaf with a tail row (1152 = 104*11 + 8), a 64-element BN leaf (k=1),
# a dense weight and a bias.
SHAPES = {"a.w": (3, 3, 8, 16), "bn.scale": (64,), "fc.w": (40, 25),
          "fc.b": (25,)}
TIMEOUT_S = 180


def _grads():
    rng = np.random.default_rng(7)
    return {n: rng.standard_normal((WORLD, STEPS) + s).astype(np.float32)
            for n, s in SHAPES.items()}


def _worker(rank, init_file, cfg, grads_path, out_paths):
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.parallel import init_process_group
    from grace_tpu_torch.transform import leaf_order

    group, _ = init_process_group("cpu", rank=rank, world_size=WORLD,
                                  init_method=f"file://{init_file}")
    try:
        with np.load(grads_path) as data:
            grads = {n: torch.from_numpy(data[n][rank]) for n in data.files}
        tx = grace_from_params(cfg, group=group).transform(seed=0)
        state = tx.init({n: g[0] for n, g in grads.items()})
        out = {}
        for s in range(STEPS):
            upd, state = tx.update({n: g[s].clone() for n, g in grads.items()},
                                   state)
            for n, u in upd.items():
                out[f"out/{s}/{n}"] = u.numpy()
            for i, n in enumerate(leaf_order(grads)):
                if state.mem[i] is not None:
                    out[f"mem/{s}/{n}"] = state.mem[i].numpy()
        np.savez(out_paths[rank], **out)
    finally:
        torch.distributed.destroy_process_group()


def _run_port(tmp_path, cfg, grads):
    grads_path = tmp_path / "grads.npz"
    np.savez(grads_path, **grads)
    outs = [tmp_path / f"rank{r}.npz" for r in range(WORLD)]
    ctx = mp.start_processes(
        _worker, args=(str(tmp_path / "store"), cfg, str(grads_path),
                         [str(o) for o in outs]),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"two-rank gloo run did not finish in {TIMEOUT_S} s")
    assert all(not p.is_alive() for p in ctx.processes)
    results = []
    for o in outs:
        with np.load(o) as data:
            results.append({k: data[k] for k in data.files})
    return results


def _run_jax(cfg, grads):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from grace_tpu import grace_from_params as jax_grace_from_params
    from grace_tpu.parallel import shard_map

    def nest(flat):
        tree = {}
        for name, a in flat.items():
            node = tree
            *parents, leaf = name.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = a
        return tree

    tx = jax_grace_from_params(cfg).transform(seed=0)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))

    def body(tree):
        g = jax.tree.map(lambda a: a[0], tree)           # (STEPS, ...)
        state = tx.init(jax.tree.map(lambda a: a[0], g))
        outs, mems = [], []
        for s in range(STEPS):
            upd, state = tx.update(jax.tree.map(lambda a: a[s], g), state)
            outs.append(upd)
            mems.append(state.mem)
        stack = lambda *xs: jnp.stack(xs)[None]         # noqa: E731
        return jax.tree.map(stack, *outs), jax.tree.map(stack, *mems)

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),),
                           out_specs=(P("data"), P("data")), check_vma=False))
    outs, mems = fn(nest({n: jnp.asarray(a) for n, a in grads.items()}))
    flat_outs = {
        ".".join(str(k.key) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(outs)[0]}
    return flat_outs, [None if m is None else np.asarray(m) for m in mems]


@pytest.mark.parametrize("cfg", [TOPK1, DENSE], ids=["topk1pct", "dense"])
def test_two_ranks_match_jax_grace_transform(tmp_path, cfg):
    from grace_tpu_torch.transform import leaf_order

    grads = _grads()
    port = _run_port(tmp_path, cfg, grads)
    jax_outs, jax_mems = _run_jax(cfg, grads)
    names = leaf_order(grads)
    assert names == ["a.w", "bn.scale", "fc.b", "fc.w"]   # the JAX order
    for r in range(WORLD):
        for s in range(STEPS):
            for i, n in enumerate(names):
                got, want = port[r][f"out/{s}/{n}"], jax_outs[n][r, s]
                if cfg is DENSE:
                    np.testing.assert_array_equal(got.view(np.int32),
                                                  want.view(np.int32))
                else:
                    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
                if jax_mems[i] is not None:
                    np.testing.assert_array_equal(
                        port[r][f"mem/{s}/{n}"].view(np.int32),
                        jax_mems[i][r, s].view(np.int32))
    # The ranks agree on every update (the exchange is global).
    for key in port[0]:
        if key.startswith("out/"):
            np.testing.assert_array_equal(port[0][key], port[1][key])


def test_rendezvous_is_local_only():
    from grace_tpu_torch.parallel import _check_local, init_process_group
    # The address check alone: nothing here may try a remote rendezvous.
    with pytest.raises(ValueError, match="not local"):
        _check_local("tcp://10.0.0.1:29500")
    _check_local("tcp://127.0.0.1:29500")
    _check_local("file:///tmp/store")
    with pytest.raises(ValueError, match="init_method"):
        init_process_group("cpu", rank=0, world_size=2)
    assert not torch.distributed.is_initialized()
