"""The catalog's registry configurations at two ranks over a real gloo
group, against the JAX package's ``grace_transform`` on a two-device
mesh: three steps each, every update and every memory and compressor
state.

The configurations are the JAX package's analysis registry entries for
these codecs, their params copied here, plus DGC with gradient clipping
and cyclic Top-K over the reduce-scatter, the two-shot and the
hierarchical all-reduce. The port's ranks are spawned processes; each
imports JAX only to draw JAX's random numbers (``JaxKey`` of
``tests/test_torch_catalog.py``, patched into the transform in place of
``LeafKey``), so the stochastic codecs draw what JAX draws. One spawn per
file runs every configuration of the file; the configurations are spread
over two files so that ``--dist loadfile`` runs them on two workers.

Tolerances, by what the codec sums in floats (bit for bit where it sums
none): see ``TOLERANCE``. This file also resumes a JAX run in the port
at step 2 (``convert.grace_state_from_jax``: PowerSGD's Q and the DGC
memory's ``{"residual", "gradient"}`` dict) and matches step 3.
"""

import time
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

WORLD, STEPS = 2, 3
# A conv kernel (HWIO), a BatchNorm scale, a dense weight and a bias.
SHAPES = {"a.w": (3, 3, 8, 16), "bn.scale": (64,), "fc.w": (40, 25),
          "fc.b": (25,)}
NAMES = ["a.w", "bn.scale", "fc.b", "fc.w"]            # the JAX leaf order
TIMEOUT_S = 300

CONFIGS = {
    # analysis registry ("powersgd-allreduce", "dgc-allgather",
    # "efsignsgd-allgather", "natural-allgather", "cyclictopk-allreduce",
    # "cyclictopk-ring"), params verbatim
    "powersgd-allreduce": {"compressor": "powersgd", "compress_rank": 2,
                           "memory": "powersgd",
                           "communicator": "allreduce"},
    "dgc-allgather": {"compressor": "dgc", "compress_ratio": 0.3,
                      "memory": "dgc", "communicator": "allgather"},
    "efsignsgd-allgather": {"compressor": "efsignsgd", "lr": 0.1,
                            "memory": "efsignsgd",
                            "communicator": "allgather"},
    "natural-allgather": {"compressor": "natural", "memory": "residual",
                          "communicator": "allgather"},
    "cyclictopk-allreduce": {"compressor": "cyclictopk",
                             "compress_ratio": 0.3, "memory": "residual",
                             "communicator": "allreduce"},
    "cyclictopk-ring": {"compressor": "cyclictopk", "compress_ratio": 0.3,
                        "memory": "residual", "communicator": "ring",
                        "fusion": "flat"},
    # DGC with the clipping's all-reduce; cyclic Top-K over the other
    # shard-parallel schedules (two slices of one rank for hier).
    "dgc-clip-allgather": {"compressor": "dgc", "compress_ratio": 0.3,
                           "memory": "dgc", "gradient_clipping": True,
                           "communicator": "allgather"},
    "cyclictopk-rscatter": {"compressor": "cyclictopk",
                            "compress_ratio": 0.3, "memory": "residual",
                            "communicator": "rscatter", "fusion": "flat"},
    "cyclictopk-twoshot": {"compressor": "cyclictopk",
                           "compress_ratio": 0.3, "memory": "residual",
                           "communicator": "twoshot", "fusion": "flat"},
    "cyclictopk-hier": {"compressor": "cyclictopk", "compress_ratio": 0.3,
                        "memory": "residual", "communicator": "hier",
                        "slice_size": 1, "fusion": "flat"},
}

# (rtol, atol) by configuration; None = bit for bit. The reasons:
TOLERANCE = {
    # P and Q: matmuls and two QRs a leaf, summed in another order; the
    # initial Q within a few ulps of JAX's draw (models/threefry.py).
    "powersgd-allreduce": (0, 2e-5),
    # the memory's momentum·u + g and v + u, which jitted XLA contracts
    # into FMAs; the selection is a count and a Top-K (bit for bit).
    "dgc-allgather": (1e-5, 1e-6),
    # the same, and the clipping's sum of squares.
    "dgc-clip-allgather": (1e-5, 1e-6),
    # the mean |x| and the memory's state + lr·x (an FMA in XLA).
    "efsignsgd-allgather": (1e-5, 1e-6),
}


def grads():
    rng = np.random.default_rng(7)
    out = {}
    for n, s in SHAPES.items():
        g = (rng.standard_normal((WORLD, STEPS) + s) * 0.8).astype(np.float32)
        g.reshape(WORLD, STEPS, -1)[..., ::7] *= 3.0
        out[n] = g
    return out


def _flat_state(prefix, entries):
    """``{prefix/i[/key]: array}`` of a list of states (None, a tensor or
    a dict of tensors)."""
    out = {}
    for i, e in enumerate(entries):
        if e is None:
            continue
        if isinstance(e, dict):
            for k, v in e.items():
                out[f"{prefix}/{i}/{k}"] = np.asarray(v)
        else:
            out[f"{prefix}/{i}"] = np.asarray(e)
    return out


def _worker(rank, init_file, cfgs, grads_path, resume_path, out_path):
    import grace_tpu_torch.transform as T
    from test_torch_catalog import JaxKey

    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.convert import grace_state_from_jax
    from grace_tpu_torch.parallel import init_process_group

    T.LeafKey = JaxKey                      # JAX's draws, as JAX draws them
    group, _ = init_process_group("cpu", rank=rank, world_size=WORLD,
                                  init_method=f"file://{init_file}")
    try:
        with np.load(grads_path) as data:
            g = {n: torch.from_numpy(data[n][rank]) for n in data.files}
        out = {}
        for name, cfg in cfgs:
            tx = grace_from_params(cfg, group=group).transform(seed=0)
            state = tx.init({n: t[0] for n, t in g.items()})
            out.update(_flat_state(f"{name}/comp/init", state.comp))
            try:
                for s in range(STEPS):
                    upd, state = tx.update({n: t[s].clone()
                                            for n, t in g.items()}, state)
                    for n, u in upd.items():
                        out[f"{name}/out/{s}/{n}"] = u.numpy()
                    out.update(_flat_state(f"{name}/mem/{s}", state.mem))
                    out.update(_flat_state(f"{name}/comp/{s}", state.comp))
            except (TypeError, ValueError) as e:
                out[f"{name}/error"] = np.array(f"{type(e).__name__}: {e}")
        if resume_path is not None:
            with np.load(resume_path, allow_pickle=True) as data:
                resume = data["resume"].item()
            for name, (cfg, jstate) in resume.items():
                tx = grace_from_params(cfg, group=group).transform(seed=0)
                state = grace_state_from_jax(jstate, seed=0, rank=rank)
                upd, state = tx.update({n: t[2].clone()
                                        for n, t in g.items()}, state)
                for n, u in upd.items():
                    out[f"resume/{name}/out/{n}"] = u.numpy()
                out.update(_flat_state(f"resume/{name}/mem", state.mem))
                out.update(_flat_state(f"resume/{name}/comp", state.comp))
        np.savez(out_path.format(rank=rank), **out)
    finally:
        torch.distributed.destroy_process_group()


def run_port(tmp, cfgs, g, resume=None):
    grads_path = f"{tmp}/grads.npz"
    np.savez(grads_path, **g)
    resume_path = None
    if resume is not None:
        resume_path = f"{tmp}/resume.npz"
        np.savez(resume_path, resume=np.array(resume, dtype=object))
    out_path = f"{tmp}/rank{{rank}}.npz"
    ctx = mp.start_processes(
        _worker, args=(f"{tmp}/store", list(cfgs.items()), grads_path,
                       resume_path, out_path),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"two-rank gloo run did not finish in {TIMEOUT_S} s")
    results = []
    for r in range(WORLD):
        with np.load(out_path.format(rank=r)) as data:
            results.append({k: data[k] for k in data.files})
    return results


def run_jax(cfg, g):
    """JAX's ``grace_transform`` on a two-device mesh, three steps:
    ``(outs, mems, comps, inits)``, each array with leading ``(W, S)``
    axes (``inits``: ``(W,)``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from grace_tpu import grace_from_params as jax_grace_from_params
    from grace_tpu.parallel import shard_map

    tx = jax_grace_from_params(cfg).transform(seed=0)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))

    def nest(flat):
        tree = {}
        for name, a in flat.items():
            *parents, leaf = name.split(".")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = a
        return tree

    def body(tree):
        gs = jax.tree.map(lambda a: a[0], tree)
        state = tx.init(jax.tree.map(lambda a: a[0], gs))
        init = jax.tree.map(lambda a: a[None], state.comp)
        outs, mems, comps = [], [], []
        for s in range(STEPS):
            upd, state = tx.update(jax.tree.map(lambda a: a[s], gs), state)
            outs.append(upd)
            mems.append(state.mem)
            comps.append(state.comp)
        stack = lambda *xs: jnp.stack(xs)[None]          # noqa: E731
        return (jax.tree.map(stack, *outs), jax.tree.map(stack, *mems),
                jax.tree.map(stack, *comps), init)

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),),
                           out_specs=P("data"), check_vma=False))
    outs, mems, comps, init = jax.device_get(fn(nest(
        {n: jnp.asarray(a) for n, a in g.items()})))
    flat_outs = {
        ".".join(str(k.key) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(outs)[0]}
    return flat_outs, list(mems), list(comps), list(init)


def _close(got, want, tol, what):
    if tol is None:
        assert got.dtype == want.dtype, what
        np.testing.assert_array_equal(
            got.view(f"u{got.dtype.itemsize}"),
            want.view(f"u{want.dtype.itemsize}"), err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1],
                                   err_msg=what)


def check_config(name, port, ref, tol):
    """Every rank's updates, memory states and compressor states at every
    step against JAX's; the ranks' updates agree."""
    outs, mems, comps, inits = ref
    for r in range(WORLD):
        assert f"{name}/error" not in port[r], port[r].get(f"{name}/error")
        for s in range(STEPS):
            for n in NAMES:
                _close(port[r][f"{name}/out/{s}/{n}"], outs[n][r, s], tol,
                       f"{name} rank {r} step {s} update of {n}")
        for kind, entries in (("mem", mems), ("comp", comps)):
            want_keys = set()
            for i, e in enumerate(entries):
                sub = ({"": e} if not isinstance(e, dict) else
                       {f"/{k}": v for k, v in e.items()})
                for k, v in sub.items():
                    if v is None:
                        continue
                    for s in range(STEPS):
                        key = f"{name}/{kind}/{s}/{i}{k}"
                        want_keys.add(key)
                        _close(port[r][key], np.asarray(v)[r, s], tol,
                               f"{key} rank {r}")
            have = {k for k in port[r] if k.startswith(f"{name}/{kind}/")
                    and "/init/" not in k}
            assert have == want_keys, (kind, have ^ want_keys)
        for i, e in enumerate(inits):
            if e is not None:
                _close(port[r][f"{name}/comp/init/{i}"], np.asarray(e)[r],
                       (0, 2e-6), f"{name} initial comp {i}")
    for key in port[0]:
        if key.startswith(f"{name}/out/"):
            np.testing.assert_array_equal(port[0][key], port[1][key])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    g = grads()
    for a in g.values():                             # no ties in |x|
        flat = np.abs(a).reshape(-1)
        assert np.unique(flat).size == flat.size
    ref = {name: run_jax(cfg, g) for name, cfg in CONFIGS.items()}
    resume = {}
    for name in ("powersgd-allreduce", "dgc-clip-allgather"):
        _, mems, comps, _ = ref[name]
        pick = lambda e: None if e is None else (           # noqa: E731
            {k: np.asarray(v)[:, 1] for k, v in e.items()}
            if isinstance(e, dict) else np.asarray(e)[:, 1])
        resume[name] = (CONFIGS[name], types.SimpleNamespace(
            count=2, mem=[pick(e) for e in mems],
            comp=[pick(e) for e in comps]))
    port = run_port(str(tmp_path_factory.mktemp("catalog")), CONFIGS, g,
                    resume)
    return port, ref


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_registry_config_matches_jax_over_three_steps(results, name):
    port, ref = results
    check_config(name, port, ref[name], TOLERANCE.get(name))


@pytest.mark.parametrize("name", ["powersgd-allreduce", "dgc-clip-allgather"])
def test_resume_a_jax_run_at_step_two(results, name):
    """``grace_state_from_jax`` carries the JAX state after two steps
    (PowerSGD's Q per leaf, the DGC memory's dict) into the port, whose
    third step then matches JAX's third step."""
    port, ref = results
    outs, mems, comps, _ = ref[name]
    tol = TOLERANCE[name]
    for r in range(WORLD):
        for n in NAMES:
            _close(port[r][f"resume/{name}/out/{n}"], outs[n][r, 2], tol,
                   f"resumed {name} update of {n}")
        for kind, entries in (("mem", mems), ("comp", comps)):
            for i, e in enumerate(entries):
                if e is None:
                    continue
                sub = ({"": e} if not isinstance(e, dict) else
                       {f"/{k}": v for k, v in e.items()})
                for k, v in sub.items():
                    _close(port[r][f"resume/{name}/{kind}/{i}{k}"],
                           np.asarray(v)[r, 2], tol, f"resumed {kind} {i}{k}")
