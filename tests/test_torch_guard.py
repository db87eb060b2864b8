"""The port's non-finite step guard against the JAX package's, on the CPU.

* Scripted NaN steps through ``guarded_chain`` (fallback after 2 bad
  steps for 2 steps, fp16 escape, telemetry on) under SGD, SGD with
  momentum (a bad first step creates its buffer) and Adam (its step
  counter lives on the host): the guard's counters equal JAX's after every
  step; the GRACE residuals and the ring equal JAX's bit for bit (norms
  within rtol 1e-6); the parameters and optimizer moments within the
  rounding of the optimizers' update (SGD: atol 1e-6; Adam: rtol 1e-5),
  after the skip, the fallback window and the re-arm.
* Four gloo ranks against JAX's four-device mesh: a NaN in one rank's
  signSGD residual (the vote swallows it on the wire) flips every rank's
  step bad through the OR over the group.
* A healthy guarded run equals the unguarded run bit for bit, across the
  codecs and memories whose state the guard must restore.
* The in-place audit: the kernels that overwrite their residual on CUDA
  (the one-leaf and grouped chunk Top-K, the grouped sign-pack) are forced
  into that spelling on the CPU, and a bad step still leaves every state
  tensor bit for bit as before it.
* ``max_norm``; the contract constants; ``guard_report``,
  ``debug_nan_residuals`` and ``GuardMonitor`` on the port's
  ``TrainState``; the train step with a guarded chain; a JAX guarded run
  resumed in the port (``convert.grace_state_from_jax``).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh, PartitionSpec as P

from grace_tpu import grace_from_params as jax_grace_from_params
from grace_tpu.parallel import shard_map
from grace_tpu.resilience import GUARD_ROLLBACK_EXCLUDED as JAX_EXCLUDED
from grace_tpu.resilience import guarded_chain as jax_guarded_chain
from grace_tpu.transform import \
    GRACE_OBSERVATIONAL_FIELDS as JAX_OBSERVATIONAL
from grace_tpu.transform import (add_world_axis, partition_specs)

from grace_tpu_torch import grace_from_params
from grace_tpu_torch.convert import grace_state_from_jax
from grace_tpu_torch.ops import chunk_topk, quant
from grace_tpu_torch.resilience import (GUARD_ROLLBACK_EXCLUDED,
                                        GUARD_SCAN_EXCLUDED_TYPES,
                                        GuardState, guard_transform,
                                        guarded_chain)
from grace_tpu_torch.telemetry import TelemetryState, WatchState
from grace_tpu_torch.transform import (GRACE_HOST_FIELDS,
                                       GRACE_OBSERVATIONAL_FIELDS,
                                       GRACE_REPLICATED_FIELDS,
                                       GRACE_VARYING_FIELDS, GraceState,
                                       fallback_flags, set_fallback_flag)
from grace_tpu_torch.utils.logging import GuardMonitor
from grace_tpu_torch.utils.metrics import debug_nan_residuals, guard_report

SHAPES = {"h1": (12, 12), "b1": (12,), "w": (12, 3), "b": (3,)}
STEPS = 9
WORLD = 4
TIMEOUT_S = 240
TOPK = {"compressor": "topk", "compress_ratio": 0.3,
        "topk_algorithm": "chunk", "memory": "residual",
        "communicator": "allgather"}
GUARDED = {**TOPK, "escape": "fp16", "telemetry": True}
GUARD_KW = {"fallback_after": 2, "fallback_steps": 2}
# optimizer -> (the port's, JAX's, bad steps, parameter tolerance)
OPTIMIZERS = {
    "sgd": (lambda ps: torch.optim.SGD(ps, lr=0.1), optax.sgd(0.1),
            (2, 3), (0, 1e-6)),
    "sgd_momentum": (lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
                     optax.sgd(0.1, momentum=0.9), (0, 3, 4), (0, 1e-6)),
    "adam": (lambda ps: torch.optim.Adam(ps, lr=0.01),
             optax.adam(0.01), (0, 3, 4), (1e-5, 1e-6)),
}


def make_grads(bad, world=1, seed=0, rank_bad=None):
    """``(world, STEPS, ...)`` gradients with a NaN lane in ``h1`` at the
    ``bad`` steps (on every rank, or on ``rank_bad`` only)."""
    rng = np.random.default_rng(seed)
    grads = {n: (rng.standard_normal((world, STEPS) + s) * 0.5).astype(
        np.float32) for n, s in SHAPES.items()}
    ranks = range(world) if rank_bad is None else [rank_bad]
    for s in bad:
        for r in ranks:
            grads["h1"][r, s, 0, 0] = np.nan
    return grads


def make_params(seed=1):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for n, s in SHAPES.items()}


def run_jax(cfg, jax_opt, grads, world=1, guard=GUARD_KW):
    """JAX's guarded chain over the steps on a ``world``-device submesh:
    a list of per-step records of the counters, the parameters, the
    residuals, the ring and the optimizer state (rank 0's, or every rank's
    stacked)."""
    tx = jax_guarded_chain(jax_grace_from_params(cfg), jax_opt, seed=1,
                           **guard)
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    params0 = {n: jnp.asarray(a) for n, a in make_params().items()}

    def body(g):
        g = jax.tree.map(lambda a: a[0], g)
        p = params0
        st = tx.init(p)
        outs = []
        for s in range(STEPS):
            u, st = tx.update(jax.tree.map(lambda a: a[s], g), st, p)
            p = optax.apply_updates(p, u)
            gs = st.inner[0]
            outs.append({"counters": jnp.stack([
                st.notfinite_count, st.last_bad_step, st.consecutive,
                st.fallback_remaining, st.step]),
                "params": p, "mem": gs.mem,
                "rings": gs.telem.rings if gs.telem is not None else None,
                "opt": st.inner[1]})
        return jax.tree.map(lambda a: a[None], outs)

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),),
                           out_specs=P("data"), check_vma=False))
    out = fn({n: jnp.asarray(a[:world]) for n, a in grads.items()})
    pick = (lambda a: np.asarray(a)) if world > 1 else \
        (lambda a: np.asarray(a)[0])
    return jax.tree.map(pick, out)


def run_port(cfg, make_opt, grads, group, rank=0, guard=GUARD_KW):
    """The port's guarded chain over the same steps: per step, the same
    records as :func:`run_jax`, and the final state."""
    chain = guarded_chain(grace_from_params(cfg, group=group), seed=1,
                          **guard)
    ps = {n: torch.nn.Parameter(torch.from_numpy(a))
          for n, a in make_params().items()}
    opt = make_opt(ps.values())
    st = chain.init(ps)
    outs = []
    for s in range(STEPS):
        st = chain.apply(ps, {n: torch.from_numpy(a[rank, s].copy())
                              for n, a in grads.items()}, st, opt)
        inner = st.inner
        outs.append({
            "counters": st.counters().numpy().copy(),
            "params": {n: p.detach().numpy().copy() for n, p in ps.items()},
            "mem": [m.numpy().copy() for m in inner.mem],
            "rings": (inner.telem.rings.numpy().copy()
                      if inner.telem is not None else None),
            "opt": {n: {k: (v.numpy().copy() if torch.is_tensor(v) else v)
                        for k, v in opt.state.get(p, {}).items()}
                    for n, p in ps.items()},
            "count": inner.count, "fallback": inner.fallback})
    return outs, st


def _jax_moments(opt_state, name):
    """The per-parameter moment arrays of optax's sgd-momentum or adam
    state, in the order torch names them."""
    leaves = []
    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda n: hasattr(n, "_fields")):
        for field in ("trace", "mu", "nu"):
            if hasattr(node, field):
                leaves.append((field, getattr(node, field)[name]))
    return leaves


def assert_step_equal(port, ref, tol, label):
    np.testing.assert_array_equal(port["counters"], ref["counters"],
                                  err_msg=f"{label} counters")
    for n in SHAPES:
        np.testing.assert_allclose(port["params"][n], ref["params"][n],
                                   rtol=tol[0], atol=tol[1],
                                   err_msg=f"{label} param {n}")
    order = sorted(SHAPES)
    for i, m in enumerate(port["mem"]):
        np.testing.assert_array_equal(m, ref["mem"][i],
                                      err_msg=f"{label} residual {order[i]}")
    if ref["rings"] is not None:
        from test_torch_telemetry import assert_ring_equal
        assert_ring_equal(port["rings"], np.zeros(1), ref["rings"],
                          np.zeros(1))


@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


# -- against JAX -----------------------------------------------------------------

@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_guarded_steps_equal_jax(group, name):
    make_opt, jax_opt, bad, tol = OPTIMIZERS[name]
    grads = make_grads(bad)
    port, _ = run_port(GUARDED, make_opt, grads, group)
    ref = run_jax(GUARDED, jax_opt, grads)
    for s in range(STEPS):
        assert_step_equal(port[s], ref[s], tol, f"{name} step {s}")
        moments = dict(_jax_moments(ref[s]["opt"], "w"))
        torch_keys = {"trace": "momentum_buffer", "mu": "exp_avg",
                      "nu": "exp_avg_sq"}
        for field, arr in moments.items():
            got = port[s]["opt"]["w"].get(torch_keys[field])
            if got is None:          # no step accepted yet: JAX's zeros
                assert not np.asarray(arr).any()
            else:
                np.testing.assert_allclose(got, arr, rtol=tol[0] or 1e-6,
                                           atol=1e-7, err_msg=field)
    # The window: the two steps after the second bad one of a pair.
    flags = [p["fallback"] for p in port]
    last = bad[-1]
    assert flags[last:last + 3] == [True, True, False]
    assert port[-1]["count"] == STEPS - len(bad)


def _worker(rank, init_file, grads_path, out_paths):
    from grace_tpu_torch.parallel import init_process_group

    group, _ = init_process_group("cpu", rank=rank, world_size=WORLD,
                                  init_method=f"file://{init_file}")
    try:
        with np.load(grads_path) as data:
            grads = {n: data[n] for n in data.files}
        outs, _ = run_port(VOTE, lambda ps: torch.optim.SGD(ps, lr=0.1),
                           grads, group, rank, guard={})
        np.savez(out_paths[rank], **{
            f"{s}/{k}": v for s, o in enumerate(outs)
            for k, v in (("counters", o["counters"]),
                         *((f"param/{n}", a) for n, a in o["params"].items()),
                         *((f"mem/{i}", m) for i, m in enumerate(o["mem"])))})
    finally:
        torch.distributed.destroy_process_group()


VOTE = {"compressor": "signsgd", "memory": "residual",
        "communicator": "allreduce"}


def test_single_rank_poison_skips_every_rank(tmp_path):
    """Rank 2's NaN stays in its residual (the vote sends a sign); its state
    scan flips the step bad, and the OR over the group skips it on every
    rank, as JAX's psum does."""
    grads = make_grads((3,), world=WORLD, seed=7, rank_bad=2)
    path = tmp_path / "grads.npz"
    np.savez(path, **grads)
    outs = [tmp_path / f"rank{r}.npz" for r in range(WORLD)]
    ctx = mp.start_processes(
        _worker, args=(str(tmp_path / "store"), str(path),
                       [str(o) for o in outs]),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"four-rank gloo run did not finish in {TIMEOUT_S} s")
    ref = run_jax(VOTE, optax.sgd(0.1), grads, world=WORLD, guard={})
    for r, o in enumerate(outs):
        with np.load(o) as data:
            for s in range(STEPS):
                np.testing.assert_array_equal(data[f"{s}/counters"],
                                              ref[s]["counters"][r])
                for n in SHAPES:
                    np.testing.assert_allclose(
                        data[f"{s}/param/{n}"], ref[s]["params"][n][r],
                        atol=1e-6, rtol=0)
                for i in range(len(SHAPES)):
                    np.testing.assert_array_equal(
                        data[f"{s}/mem/{i}"], ref[s]["mem"][i][r])
    assert list(ref[-1]["counters"][0][:2]) == [1, 3]


# -- pass-through and the in-place audit -----------------------------------

def _inplace(wrapper, residual_arg, pick):
    """``wrapper`` spelled as its CUDA branch writes: each new residual
    copied over the residual it was given, which is returned in its
    place."""
    def call(*args, **kwargs):
        out = wrapper(*args, **kwargs)
        residuals = args[residual_arg] if len(args) > residual_arg else \
            kwargs.get("residuals", kwargs.get("residual"))
        return pick(out, residuals)
    return call


def _over_each(out, residuals):
    vals, idx, new = out
    kept = []
    for old, n in zip(residuals, new):
        if old is None:
            kept.append(n)
        else:
            old.copy_(n.reshape(old.shape))
            kept.append(old)
    return vals, idx, kept


def _over_one(out, residual):
    vals, win, new = out
    if residual is None:
        return out
    residual.copy_(new.reshape(residual.shape))
    return vals, win, residual


def _over_signs(out, residuals):
    payload, new = out
    if residuals is None:
        return out
    for old, n in zip(residuals, new):
        old.copy_(n.reshape(old.shape))
    return payload, list(residuals)


@pytest.fixture
def in_place(monkeypatch):
    """Force the CUDA branch's in-place residual writes on the CPU."""
    monkeypatch.setattr(chunk_topk, "chunk_compress_feedback_grouped",
                        _inplace(chunk_topk.chunk_compress_feedback_grouped,
                                 1, _over_each))
    monkeypatch.setattr(chunk_topk, "chunk_compress_feedback",
                        _inplace(chunk_topk.chunk_compress_feedback, 1,
                                 _over_one))
    monkeypatch.setattr(quant, "sign_pack_grouped",
                        _inplace(quant.sign_pack_grouped, 1, _over_signs))


# name -> params; each case's state must survive a bad step bit for bit
ROLLBACK_CASES = {
    "topk_chunk_grouped_kernel": TOPK,
    "topk_chunk_flat": {**TOPK, "fusion": "flat"},
    "topk_chunk_grouped_fusion": {**TOPK, "fusion": "grouped"},
    "topk_chunk_one_leaf_kernel": {**TOPK, "communicator": "identity"},
    "signsgd_vote_feedback": VOTE,
    "dgc": {"compressor": "dgc", "compress_ratio": 0.3, "memory": "dgc",
            "communicator": "allgather"},
    "powersgd": {"compressor": "powersgd", "compress_rank": 2,
                 "memory": "powersgd", "communicator": "allreduce"},
    "efsignsgd": {"compressor": "efsignsgd", "memory": "efsignsgd",
                  "communicator": "allgather"},
}


def _state_bits(st, ps, opt):
    inner = st.inner
    from grace_tpu_torch.transform import _state_tensors as _tensors
    return ([p.detach().clone() for p in ps.values()]
            + [v.clone() for p in ps.values()
               for v in opt.state.get(p, {}).values() if torch.is_tensor(v)]
            + [t.clone() for t in _tensors(inner.mem) + _tensors(inner.comp)]
            + ([inner.telem.rings.clone(), inner.telem.steps.clone()]
               if inner.telem is not None else []), inner.count)


@pytest.mark.parametrize("case", list(ROLLBACK_CASES))
def test_bad_step_restores_state_in_place_spelling(group, in_place, case):
    cfg = {**ROLLBACK_CASES[case], "telemetry": True}
    grads = make_grads((2,), seed=4)
    chain = guarded_chain(grace_from_params(cfg, group=group), seed=1)
    ps = {n: torch.nn.Parameter(torch.from_numpy(a))
          for n, a in make_params().items()}
    opt = torch.optim.SGD(ps.values(), lr=0.1, momentum=0.9)
    st = chain.init(ps)
    mem_ids = None
    for s in range(4):
        st = chain.apply(ps, {n: torch.from_numpy(a[0, s].copy())
                              for n, a in grads.items()}, st, opt)
        if s == 0:
            mem_ids = [t.data_ptr() for t in st.inner.mem
                       if torch.is_tensor(t)]
        if s == 1:
            before, count = _state_bits(st, ps, opt)
            if case.startswith(("topk_chunk_grouped_kernel", "topk_chunk_one",
                                "topk_chunk_flat", "signsgd")):
                # The forced spelling is live: the residuals are the same
                # storage, overwritten.
                assert [t.data_ptr() for t in st.inner.mem] == mem_ids
        if s == 2:
            after, count2 = _state_bits(st, ps, opt)
            assert count2 == count
            assert len(after) == len(before)
            for a, b in zip(after, before):
                assert torch.equal(a.view(-1).view(torch.uint8),
                                   b.view(-1).view(torch.uint8))
    assert guard_report(st)["notfinite_count"] == 1


@pytest.mark.parametrize("case", list(ROLLBACK_CASES))
def test_healthy_guarded_run_equals_unguarded(group, case):
    cfg = ROLLBACK_CASES[case]
    grads = make_grads(())
    grc = grace_from_params(cfg, group=group)
    chain = guarded_chain(grc, seed=1)
    tx = grc.transform(seed=1)
    pa = {n: torch.nn.Parameter(torch.from_numpy(a))
          for n, a in make_params().items()}
    pb = {n: torch.nn.Parameter(torch.from_numpy(a))
          for n, a in make_params().items()}
    oa = torch.optim.SGD(pa.values(), lr=0.1, momentum=0.9)
    ob = torch.optim.SGD(pb.values(), lr=0.1, momentum=0.9)
    sa, sb = tx.init(pa), chain.init(pb)
    for s in range(4):
        g = {n: torch.from_numpy(a[0, s].copy()) for n, a in grads.items()}
        updates, sa = tx.update({n: t.clone() for n, t in g.items()}, sa)
        for n, p in pa.items():
            p.grad = updates[n]
        oa.step()
        sb = chain.apply(pb, g, sb, ob)
    from grace_tpu_torch.transform import _state_tensors as _tensors
    for a, b in zip(list(pa.values()) + _tensors(sa.mem) + _tensors(sa.comp),
                    list(pb.values()) + _tensors(sb.inner.mem)
                    + _tensors(sb.inner.comp)):
        assert torch.equal(a.detach().view(-1).view(torch.uint8),
                           b.detach().view(-1).view(torch.uint8))
    assert sb.inner.count == sa.count == 4


# -- the rest of the guard -------------------------------------------------------

def test_guard_max_norm_bound(group):
    grc = grace_from_params({"compressor": "none", "memory": "none",
                             "communicator": "allreduce"}, group=group)
    chain = guard_transform(grc.transform(), max_norm=1.0)
    ps = {"w": torch.nn.Parameter(torch.ones(4))}
    opt = torch.optim.SGD(ps.values(), lr=1.0)
    st = chain.init(ps)
    st = chain.apply(ps, {"w": torch.full((4,), 100.0)}, st, opt)
    assert guard_report(st)["notfinite_count"] == 1
    assert torch.equal(ps["w"].detach(), torch.ones(4))
    st = chain.apply(ps, {"w": torch.full((4,), 0.01)}, st, opt)
    assert guard_report(st)["notfinite_count"] == 1
    torch.testing.assert_close(ps["w"].detach(), torch.full((4,), 0.99))


def test_contract_constants_and_flags(group):
    assert GUARD_ROLLBACK_EXCLUDED == JAX_EXCLUDED
    # The observational rings: telemetry, and the watch ring since it was
    # ported, as in JAX.
    assert GRACE_OBSERVATIONAL_FIELDS == JAX_OBSERVATIONAL == (
        "telem", "watch")
    assert GUARD_SCAN_EXCLUDED_TYPES == (TelemetryState, WatchState)
    # Every field is per rank or replicated, but the port's one host
    # bookkeeping field: the world the state was initialized at.
    assert GRACE_HOST_FIELDS == ("world",)
    assert set(GRACE_VARYING_FIELDS) | set(GRACE_REPLICATED_FIELDS) | set(
        GRACE_HOST_FIELDS) == {
        f.name for f in __import__("dataclasses").fields(GraceState)}
    with pytest.raises(ValueError, match="set together"):
        guard_transform(grace_from_params(TOPK).transform(), fallback_after=2)
    chain = guarded_chain(grace_from_params(GUARDED, group=group))
    st = chain.init({n: torch.zeros(s) for n, s in SHAPES.items()})
    assert fallback_flags(st) == [False]
    flipped = set_fallback_flag([st, {"x": st.inner}], True)
    assert fallback_flags(flipped) == [True, True]
    assert isinstance(flipped[0], GuardState)


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.h = torch.nn.Parameter(torch.randn(8, 16, generator=gen) * 0.3)
        self.w = torch.nn.Parameter(torch.randn(16, 3, generator=gen) * 0.3)

    def forward(self, x):
        return torch.tanh(x @ self.h) @ self.w


def _loss(model, batch):
    x, y = batch
    return torch.nn.functional.cross_entropy(model(x), y)


def test_train_step_with_a_guarded_chain(group):
    """``make_train_step`` takes the guarded chain; a NaN planted by a
    tensor hook is skipped, the model rolls back, ``guard_report`` and
    ``GuardMonitor`` see it, ``debug_nan_residuals`` finds a planted NaN."""
    from grace_tpu_torch.train import init_train_state, make_train_step
    model = _MLP()
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    chain = guarded_chain(grace_from_params(GUARDED, group=group),
                          fallback_after=1, fallback_steps=1)
    state = init_train_state(model, chain, opt, group)
    step = make_train_step(_loss, chain, group)
    bad = [False]

    def poison(g):
        if bad[0]:
            g = g.clone()
            g[0, 0] = float("nan")
        return g

    model.h.register_hook(poison)
    gen = torch.Generator().manual_seed(1)
    batch = (torch.randn(32, 8, generator=gen),
             torch.randint(0, 3, (32,), generator=gen))
    events = []
    mon = GuardMonitor(printer=events.append)
    for i in range(5):
        bad[0] = i == 2
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        state, loss = step(state, batch)
        mon.update(i, guard_report(state))
        if i == 2:
            for n, p in model.named_parameters():
                assert torch.equal(p.detach(), before[n])
    report = guard_report(state)
    assert (report["notfinite_count"], report["last_bad_step"],
            report["fallback_remaining"], report["step"]) == (1, 2, 0, 5)
    assert len(events) == 3 and "re-armed" in events[-1]
    assert debug_nan_residuals(state) == {}
    state.grace.inner.mem[0][0, 1] = float("inf")
    assert debug_nan_residuals(state) == {"grace/inner/mem/0":
                                          {"nan": 0, "inf": 1}}


def test_jax_guarded_run_resumes_in_the_port(group):
    """Three guarded JAX steps (one bad), carried across with
    ``grace_state_from_jax``, then three more in each package: equal."""
    grads = make_grads((1, 4))
    tx = jax_guarded_chain(jax_grace_from_params(GUARDED), optax.sgd(0.1),
                           seed=1, **GUARD_KW)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    params0 = {n: jnp.asarray(a) for n, a in make_params().items()}
    specs = partition_specs(jax.eval_shape(tx.init, params0), "data")

    def body(g, n0, n1):
        g = jax.tree.map(lambda a: a[0], g)
        p = params0
        st = tx.init(p)
        mid = None
        for s in range(n1):
            u, st = tx.update(jax.tree.map(lambda a: a[s], g), st, p)
            p = optax.apply_updates(p, u)
            if s == n0 - 1:
                mid = (p, add_world_axis(st))
        return mid, (p, add_world_axis(st))

    fn = jax.jit(shard_map(lambda g: body(g, 3, 6), mesh=mesh,
                           in_specs=(P("data"),),
                           out_specs=((P(), specs), (P(), specs)),
                           check_vma=False))
    (p3, st3), (p6, st6) = jax.device_get(fn(
        {n: jnp.asarray(a) for n, a in grads.items()}))
    state = grace_state_from_jax(st3, seed=1, rank=0)
    assert isinstance(state, GuardState)
    assert state.inner.count == 2 and state.inner.telem is not None
    chain = guarded_chain(grace_from_params(GUARDED, group=group), seed=1,
                          **GUARD_KW)
    ps = {n: torch.nn.Parameter(torch.from_numpy(np.array(a)))
          for n, a in p3.items()}
    opt = torch.optim.SGD(ps.values(), lr=0.1)
    for s in range(3, 6):
        state = chain.apply(ps, {n: torch.from_numpy(a[0, s].copy())
                                 for n, a in grads.items()}, state, opt)
    want = grace_state_from_jax(st6, seed=1, rank=0)
    np.testing.assert_array_equal(state.counters().numpy(),
                                  want.counters().numpy())
    assert (state.inner.count, state.inner.fallback) == (
        want.inner.count, want.inner.fallback)
    for a, b in zip(state.inner.mem, want.inner.mem):
        assert torch.equal(a, b)
    for n, p in ps.items():
        np.testing.assert_allclose(p.detach().numpy(), p6[n], atol=1e-6)
