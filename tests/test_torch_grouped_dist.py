"""The grouped chunk Top-K path of ``grace_transform`` over a gloo group of
two spawned ranks: ``Allgather.step_leaves`` takes every leaf that passes
the gates through one grouped compress, one gather of each payload tensor
and one grouped aggregate a step, and must equal a loop of
``Communicator.step`` bit for bit, updates and residuals; a float16 leaf and
a one-element leaf fail the gates and take the per-leaf path.

No JAX here, so the spawned ranks stay light; the grouped plain versions are
held against the JAX Pallas kernels in ``test_torch_grouped.py``.
"""

import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from grace_tpu_torch.ops import chunk_topk as ck

# -- the transform over two spawned gloo ranks --------------------------------

TOPK1 = {"compressor": "topk", "compress_ratio": 0.01,
         "topk_algorithm": "chunk", "memory": "residual",
         "communicator": "allgather", "fusion": "none"}
WORLD, STEPS = 2, 3
# Leaves that fail the grouped gates: a float16 leaf and a 1-element leaf.
EXTRA = {"extra.half": ((5, 7), np.float16), "extra.one": ((1,), np.float32)}
TIMEOUT_S = 180


def _reduced_resnet_shapes():
    from grace_tpu_torch.models.resnet import ResNet
    model = ResNet((1, 1, 0, 0), 10, device="cpu")
    shapes = {n: (tuple(p.shape), np.float32)
              for n, p in model.named_parameters()}
    return {**shapes, **EXTRA}


def _worker(rank, init_file, grads_path, out_paths):
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.core import LeafKey
    from grace_tpu_torch.parallel import init_process_group
    from grace_tpu_torch.transform import leaf_order

    calls = {"compress": 0, "aggregate": 0}
    compress, aggregate = (ck.chunk_compress_feedback_grouped,
                           ck.chunk_aggregate_dense_grouped)

    def counted(fn, key):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    ck.chunk_compress_feedback_grouped = counted(compress, "compress")
    ck.chunk_aggregate_dense_grouped = counted(aggregate, "aggregate")
    group, _ = init_process_group("cpu", rank=rank, world_size=WORLD,
                                  init_method=f"file://{init_file}")
    try:
        with np.load(grads_path) as data:
            grads = {n: torch.from_numpy(data[n][rank]) for n in data.files}
        tx = grace_from_params(TOPK1, group=group).transform(seed=0)
        names = leaf_order(grads)
        state = tx.init({n: g[0] for n, g in grads.items()})
        ref = tx.init({n: g[0] for n, g in grads.items()})
        out = {}
        for s in range(STEPS):
            upd, state = tx.update({n: g[s].clone() for n, g in grads.items()},
                                   state)
            mems = []
            for i, n in enumerate(names):       # the per-leaf loop
                o, m, c = tx.communicator.step(
                    grads[n][s].clone(), ref.mem[i], ref.comp[i], tx.memory,
                    tx.compressor, LeafKey(ref.seed, ref.count, i))
                out[f"ref_out/{s}/{n}"] = o.numpy()
                mems.append(m)
            ref.mem, ref.count = mems, ref.count + 1
            for i, n in enumerate(names):
                out[f"out/{s}/{n}"] = upd[n].numpy()
                out[f"mem/{s}/{n}"] = state.mem[i].numpy()
                out[f"ref_mem/{s}/{n}"] = ref.mem[i].numpy()
        out["calls"] = np.array([calls["compress"], calls["aggregate"]])
        np.savez(out_paths[rank], **out)
    finally:
        torch.distributed.destroy_process_group()


def test_grouped_transform_matches_per_leaf_step_loop(tmp_path):
    shapes = _reduced_resnet_shapes()
    rng = np.random.default_rng(3)
    grads = {n: rng.standard_normal((WORLD, STEPS) + s).astype(dt)
             for n, (s, dt) in shapes.items()}
    grads_path = tmp_path / "grads.npz"
    np.savez(grads_path, **grads)
    outs = [tmp_path / f"rank{r}.npz" for r in range(WORLD)]
    ctx = mp.start_processes(
        _worker, args=(str(tmp_path / "store"), str(grads_path),
                       [str(o) for o in outs]),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"two-rank gloo run did not finish in {TIMEOUT_S} s")
    results = []
    for o in outs:
        with np.load(o) as data:
            results.append({k: data[k] for k in data.files})
    for res in results:
        # One grouped compress and one grouped aggregate a step.
        np.testing.assert_array_equal(res["calls"], [STEPS, STEPS])
        for s in range(STEPS):
            for n, (shape, dt) in shapes.items():
                for kind in ("out", "mem"):
                    got, want = res[f"{kind}/{s}/{n}"], res[f"ref_{kind}/{s}/{n}"]
                    assert got.dtype == want.dtype == dt and got.shape == shape
                    iv = np.int16 if dt == np.float16 else np.int32
                    np.testing.assert_array_equal(got.view(iv), want.view(iv),
                                                  err_msg=f"{kind} {n} {s}")
    for key in results[0]:
        if key.startswith("out/"):
            np.testing.assert_array_equal(results[0][key], results[1][key])
