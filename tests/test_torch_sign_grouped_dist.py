"""The grouped signSGD vote of ``grace_transform`` over a gloo group of two
spawned ranks: ``SignAllreduce.step_leaves`` and the ``Allreduce`` vote
routing take every leaf that passes the gates through one grouped
sign-pack, one decode of the concatenated payload, one all-reduce and one
re-sign a step, and must equal a loop of ``Communicator.step`` bit for bit,
updates and residuals, under residual memory and under none. Signum (its
momentum stays per leaf) and a bfloat16-state residual take the per-leaf
path and keep their results; a float16 leaf fails the gates in every
configuration.

One spawn runs every configuration; no JAX here, so the spawned ranks stay
light. The grouped plain version is held against the JAX Pallas kernel in
``test_torch_sign_grouped.py``.
"""

import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from grace_tpu_torch.ops import quant

VOTE = {"compressor": "signsgd", "memory": "residual",
        "communicator": "sign_allreduce", "fusion": "none"}
# name: (params, grouped sign-pack calls a step)
CONFIGS = {
    "sign_allreduce_residual": (VOTE, 1),
    "sign_allreduce_none": (dict(VOTE, memory="none"), 1),
    "allreduce_residual": (dict(VOTE, communicator="allreduce"), 1),
    "allreduce_none": (dict(VOTE, communicator="allreduce", memory="none"),
                       1),
    "residual_beta_gamma": (dict(VOTE, beta=0.9, gamma=0.5), 1),
    "signum": ({"compressor": "signum", "momentum": 0.9, "memory": "none",
                "communicator": "sign_allreduce", "fusion": "none"}, 0),
    "residual_bf16_state": (dict(VOTE, memory_dtype="bfloat16"), 0),
}
WORLD, STEPS = 2, 3
# A float16 leaf fails the gates; a one-element leaf passes them.
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

    torch.set_num_threads(1)              # two ranks share the host
    calls = [0]
    grouped = quant.sign_pack_grouped

    def counted(*args, **kwargs):
        calls[0] += 1
        return grouped(*args, **kwargs)

    quant.sign_pack_grouped = counted
    group, _ = init_process_group("cpu", rank=rank, world_size=WORLD,
                                  init_method=f"file://{init_file}")
    try:
        with np.load(grads_path) as data:
            grads = {n: torch.from_numpy(data[n][rank]) for n in data.files}
        names = leaf_order(grads)
        out = {}
        for cname, (params, _) in CONFIGS.items():
            calls[0] = 0
            tx = grace_from_params(params, group=group).transform(seed=0)
            state = tx.init({n: g[0] for n, g in grads.items()})
            ref = tx.init({n: g[0] for n, g in grads.items()})
            for s in range(STEPS):
                upd, state = tx.update(
                    {n: g[s].clone() for n, g in grads.items()}, state)
                mems, comps = [], []
                for i, n in enumerate(names):       # the per-leaf loop
                    o, m, c = tx.communicator.step(
                        grads[n][s].clone(), ref.mem[i], ref.comp[i],
                        tx.memory, tx.compressor,
                        LeafKey(ref.seed, ref.count, i))
                    out[f"{cname}/ref_out/{s}/{n}"] = o.numpy()
                    mems.append(m)
                    comps.append(c)
                ref.mem, ref.comp, ref.count = mems, comps, ref.count + 1
                for i, n in enumerate(names):
                    out[f"{cname}/out/{s}/{n}"] = upd[n].numpy()
                    for kind, st in (("mem", state.mem[i]),
                                     ("ref_mem", ref.mem[i])):
                        if isinstance(st, torch.Tensor):
                            out[f"{cname}/{kind}/{s}/{n}"] = st.float().numpy()
                        elif isinstance(st, dict):   # Signum's momentum
                            out[f"{cname}/{kind}/{s}/{n}"] = \
                                st["momentum"].float().numpy()
            out[f"{cname}/calls"] = np.array(calls[0])
        np.savez(out_paths[rank], **out)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("sign_grouped_dist")
    shapes = _reduced_resnet_shapes()
    rng = np.random.default_rng(5)
    grads = {}
    for n, (s, dt) in shapes.items():
        g = rng.standard_normal((WORLD, STEPS) + s).astype(dt)
        flat = g.reshape(WORLD, STEPS, -1)
        flat[:, :, 0] = -0.0                      # a signed zero on every rank
        flat[0, :, -1] = -flat[1, :, -1]          # a tied vote
        grads[n] = g
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
    loaded = []
    for o in outs:
        with np.load(o) as data:
            loaded.append({k: data[k] for k in data.files})
    return shapes, loaded


@pytest.mark.parametrize("config", list(CONFIGS))
def test_grouped_vote_matches_per_leaf_step_loop(results, config):
    shapes, per_rank = results
    _, calls_a_step = CONFIGS[config]
    for res in per_rank:
        assert int(res[f"{config}/calls"]) == calls_a_step * STEPS
        for s in range(STEPS):
            for n, (shape, dt) in shapes.items():
                got = res[f"{config}/out/{s}/{n}"]
                want = res[f"{config}/ref_out/{s}/{n}"]
                assert got.dtype == want.dtype == dt and got.shape == shape
                iv = np.int16 if dt == np.float16 else np.int32
                np.testing.assert_array_equal(got.view(iv), want.view(iv),
                                              err_msg=f"out {n} {s}")
                assert set(np.unique(got)) <= {-1.0, 1.0}
                key = f"{config}/mem/{s}/{n}"
                assert (key in res) == (f"{config}/ref_mem/{s}/{n}" in res)
                if key in res:
                    np.testing.assert_array_equal(
                        res[key].view(np.int32),
                        res[f"{config}/ref_mem/{s}/{n}"].view(np.int32),
                        err_msg=f"mem {n} {s}")
    # The vote is the same on both ranks.
    for key in per_rank[0]:
        if key.startswith(f"{config}/out/"):
            np.testing.assert_array_equal(per_rank[0][key], per_rank[1][key])
