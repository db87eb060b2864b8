"""The port's consistency audit and its repair against the JAX package's,
on the CPU.

* ``masked_broadcast``: rank 3's bits on every one of four gloo ranks,
  ``-0.0`` and NaN payloads, int32, int64, bool, bfloat16 and float64
  included; the identity at one rank.
* ``fingerprint_tree``: the checksum words equal JAX's bit for bit on the
  same list of arrays (float32 with ``-0.0`` and NaN payloads, bfloat16,
  int32, bool, float64 split into low then high words, an empty leaf,
  chunked streams); the float fold within rtol 1e-6 (another summation
  order); sensitivity to a value, a sign of zero, a swap, an int.
* At four gloo ranks against JAX's four-device mesh (SGD at lr 0.25, a
  power of two, so both packages round the parameter update once): a bit
  flipped by ``ChaosParams`` in rank 1's copy of the parameters is found at
  the next audit and repaired; after every step the parameters, the guard's
  counters, the ``AuditState``, the fallback flag and every rank's
  residuals equal JAX's bit for bit, and the ring's rows too (byte columns
  exact: ``audit_bytes`` is the gather's 256 B, plus the repair's 833 B on
  the repair step). The chunk kernels' in-place residual writes are forced
  on the CPU, and the divergent rank's residuals are zero after the repair.
* Escalation: the same rank diverging twice within the window opens the
  dense window on JAX's step, for JAX's number of steps.
* A healthy run with the audit on equals the run with it off, bit for bit.
* The configuration's spellings and errors, the unarmed-state error,
  ``ConsensusMonitor``'s transitions, ``ChaosParams``' choice of (leaf,
  element, bit) equal to JAX's, the train step's hook, the checkpoint's
  ``audit``, and a JAX ``AuditState`` carried by ``convert``.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from grace_tpu import grace_from_params as jax_grace_from_params
from grace_tpu.resilience import ChaosParams as JaxChaosParams
from grace_tpu.resilience import ConsensusConfig as JaxConsensusConfig
from grace_tpu.resilience import consensus_step as jax_consensus_step
from grace_tpu.resilience import fingerprint_tree as jax_fingerprint_tree
from grace_tpu.resilience import guarded_chain as jax_guarded_chain
from grace_tpu.train import TrainState as JaxTrainState
from grace_tpu.train import _lazy_sharded_step, init_train_state
from grace_tpu.transform import add_world_axis, strip_world_axis

from grace_tpu_torch import grace_from_params
from grace_tpu_torch.comm import masked_broadcast, masked_broadcast_tree
from grace_tpu_torch.ops import chunk_topk
from grace_tpu_torch.resilience import (ChaosParams, ConsensusConfig,
                                        audit_report, consensus_step,
                                        fingerprint_tree, force_audit,
                                        guarded_chain, normalize_consensus,
                                        replicated_view)
from grace_tpu_torch.resilience import consensus as consensus_mod
from grace_tpu_torch.train import TrainState
from grace_tpu_torch.transform import AuditState
from grace_tpu_torch.utils.logging import ConsensusMonitor

WORLD = 4
TIMEOUT_S = 240
SHAPES = {"h1": (12, 12), "b1": (12,), "w": (12, 3), "b": (3,)}
LR = 0.25
CFG = {"compressor": "topk", "compress_ratio": 0.3,
       "topk_algorithm": "chunk", "memory": "residual",
       "communicator": "allgather", "escape": "fp16", "telemetry": 64,
       "consensus": True}
# scenario -> (params over CFG, consensus config kwargs, chaos kwargs,
# steps). The escalation's dense window runs the float32 escape: an fp16
# all-reduce over gloo rounds differently from XLA's psum (ROADMAP queue
# 3), and the float32 sums differ only in order.
SCENARIOS = {
    "repair": ({}, {"audit_every": 4},
               {"rank": 1, "at_steps": (5,), "seed": 9}, 12),
    "escalate": ({"escape": "none"},
                 {"audit_every": 2, "escalate_window": 50,
                  "escalate_steps": 4},
                 {"rank": 2, "at_steps": (1, 3), "seed": 13}, 10),
}


def make_grads(steps, seed=0):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal((WORLD, steps) + s) * 0.5).astype(
        np.float32) for n, s in SHAPES.items()}


def make_params(seed=1):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for n, s in SHAPES.items()}


# -- the runs -------------------------------------------------------------------

def run_jax(name, grads):
    """JAX's guarded chain + consensus hook on a four-device mesh, with
    JAX's ChaosParams between steps: per step, every device's parameters,
    the guard counters, the AuditState, the fallback flag, every rank's
    residuals and rings."""
    over, ckw, chaos_kw, steps = SCENARIOS[name]
    cfg = JaxConsensusConfig(**ckw)
    tx = jax_guarded_chain(jax_grace_from_params({**CFG, **over}),
                           optax.sgd(LR), seed=1)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    state = init_train_state({n: jnp.asarray(a)
                              for n, a in make_params().items()}, tx, mesh)

    def device_step(st, batch):
        g = jax.tree.map(lambda a: a[0], batch)
        opt = strip_world_axis(st.opt_state)
        updates, opt = tx.update(g, opt, st.params)
        params = optax.apply_updates(st.params, updates)
        params, opt = jax_consensus_step((params, opt), cfg, "data")
        return JaxTrainState(params, add_world_axis(opt)), jnp.zeros(())

    step = _lazy_sharded_step(device_step, mesh, "data", donate=False)
    chaos = JaxChaosParams(**chaos_kw)
    out = []
    for s in range(steps):
        state = chaos(state, s)
        state, _ = step(state, {n: jnp.asarray(a[:, s])
                                for n, a in grads.items()})
        guard = state.opt_state
        gs = guard.inner[0]
        out.append({
            "params": {n: np.stack([np.asarray(sh.data) for sh in sorted(
                leaf.addressable_shards, key=lambda sh: sh.device.id)])
                for n, leaf in state.params.items()},
            "counters": np.array([int(np.asarray(getattr(guard, f)).reshape(
                -1)[0]) for f in ("notfinite_count", "last_bad_step",
                                  "consecutive", "fallback_remaining",
                                  "step")]),
            "audit": [int(np.asarray(v).reshape(-1)[0]) for v in gs.audit],
            "fallback": bool(np.asarray(gs.fallback).reshape(-1)[0]),
            "mem": [np.asarray(m) for m in gs.mem],
            "rings": np.asarray(gs.telem.rings),
            "steps": np.asarray(gs.telem.steps)})
    return out, chaos.injections


def _inplace_spelling():
    """The CUDA branch's in-place residual writes, forced on the CPU."""
    grouped = chunk_topk.chunk_compress_feedback_grouped

    def call(grads, residuals, *args, **kwargs):
        vals, idx, new = grouped(grads, residuals, *args, **kwargs)
        kept = []
        for old, n in zip(residuals, new):
            if old is None:
                kept.append(n)
            else:
                old.copy_(n.reshape(old.shape))
                kept.append(old)
        return vals, idx, kept

    chunk_topk.chunk_compress_feedback_grouped = call


def run_port(name, grads, group, rank):
    """The same run in the port, this rank's side of it."""
    over, ckw, chaos_kw, steps = SCENARIOS[name]
    cfg = ConsensusConfig(**ckw)
    chain = guarded_chain(grace_from_params({**CFG, **over}, group=group),
                          seed=1)
    ps = {n: torch.nn.Parameter(torch.from_numpy(a))
          for n, a in make_params().items()}
    model = torch.nn.ParameterDict(ps)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    state = TrainState(model, opt, chain.init(ps))
    chaos = ChaosParams(group=group, **chaos_kw)
    out = []
    for s in range(steps):
        state = chaos(state, s)
        grace = chain.apply(ps, {n: torch.from_numpy(a[rank, s].copy())
                                 for n, a in grads.items()},
                            state.grace, opt)
        state = consensus_step(TrainState(model, opt, grace), cfg, group)
        inner = state.grace.inner
        out.append({
            "params": {n: p.detach().numpy().copy() for n, p in ps.items()},
            "counters": state.grace.counters().numpy().copy(),
            "audit": list(inner.audit), "fallback": inner.fallback,
            "mem": [m.numpy().copy() for m in inner.mem],
            "rings": inner.telem.rings.numpy().copy(),
            "steps": inner.telem.steps.numpy().copy()})
    return out, chaos.injections


def _broadcast_cases(rank):
    """Per-rank inputs whose rank-3 values carry every hard bit pattern."""
    f = np.full(6, float(rank), np.float32)
    if rank == 3:
        f[:] = [-0.0, np.nan, 1.5, -2.5, 0.0, np.inf]
        f.view(np.uint32)[4] = 0x7FC00123          # a NaN payload
    return {"f32": torch.from_numpy(f),
            "i32": torch.tensor([rank, -rank, 2**31 - 1 - rank],
                                dtype=torch.int32),
            "i64": torch.tensor([rank * 2**40, -rank], dtype=torch.int64),
            "bool": torch.tensor([rank > 2, rank == 1]),
            "bf16": torch.tensor([rank - 0.5, -0.0 if rank == 3 else 1.0],
                                 dtype=torch.bfloat16),
            "f64": torch.tensor([rank + 1e-17, -rank], dtype=torch.float64)}


def _worker(rank, init_file, grads_paths, out_paths):
    from grace_tpu_torch.parallel import init_process_group

    group, _ = init_process_group("cpu", rank=rank, world_size=WORLD,
                                  init_method=f"file://{init_file}")
    _inplace_spelling()
    try:
        out = {}
        cases = _broadcast_cases(rank)
        tree = masked_broadcast_tree(cases, 3, group)
        for k, v in tree.items():
            out[f"bcast/{k}"] = v.view(-1).view(torch.uint8).numpy().copy()
        for name in SCENARIOS:
            with np.load(grads_paths[name]) as data:
                grads = {n: data[n] for n in data.files}
            recs, injections = run_port(name, grads, group, rank)
            out[f"{name}/injections"] = np.array(injections)
            for s, r in enumerate(recs):
                for n, a in r["params"].items():
                    out[f"{name}/{s}/param/{n}"] = a
                for i, m in enumerate(r["mem"]):
                    out[f"{name}/{s}/mem/{i}"] = m
                for k in ("counters", "rings", "steps"):
                    out[f"{name}/{s}/{k}"] = r[k]
                out[f"{name}/{s}/audit"] = np.array(r["audit"])
                out[f"{name}/{s}/fallback"] = np.array(r["fallback"])
        out["healthy"] = np.array(_healthy_on_equals_off(group, rank))
        np.savez(out_paths[rank], **out)
    finally:
        torch.distributed.destroy_process_group()


def _healthy_on_equals_off(group, rank):
    """Four updates with the audit at every step and without it: the
    parameters and residuals bit for bit, three audits and no repair."""
    grads = make_grads(4, seed=2)
    runs = []
    for consensus in (ConsensusConfig(audit_every=1), None):
        cfg = {**CFG, "consensus": consensus}
        chain = guarded_chain(grace_from_params(cfg, group=group), seed=1)
        ps = {n: torch.nn.Parameter(torch.from_numpy(a))
              for n, a in make_params().items()}
        model = torch.nn.ParameterDict(ps)
        opt = torch.optim.SGD(model.parameters(), lr=LR)
        state = TrainState(model, opt, chain.init(ps))
        for s in range(4):
            grace = chain.apply(ps, {n: torch.from_numpy(a[rank, s].copy())
                                     for n, a in grads.items()},
                                state.grace, opt)
            state = consensus_step(TrainState(model, opt, grace), consensus,
                                   group)
        runs.append(([p.detach().clone() for p in ps.values()]
                     + list(state.grace.inner.mem), audit_report(state)))
    (a, rep_on), (b, rep_off) = runs
    same = all(torch.equal(x.view(-1).view(torch.uint8),
                           y.view(-1).view(torch.uint8)) for x, y in zip(a, b))
    return [same, rep_on["audits"], rep_on["repairs"], rep_off == {}]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One four-rank gloo run of every scenario, and JAX's runs."""
    tmp = tmp_path_factory.mktemp("consensus")
    grads = {name: make_grads(SCENARIOS[name][3], seed=i)
             for i, name in enumerate(SCENARIOS)}
    paths = {}
    for name, g in grads.items():
        paths[name] = str(tmp / f"{name}.npz")
        np.savez(paths[name], **g)
    outs = [tmp / f"rank{r}.npz" for r in range(WORLD)]
    ctx = mp.start_processes(
        _worker, args=(str(tmp / "store"), paths, [str(o) for o in outs]),
        nprocs=WORLD, join=False, start_method="spawn")
    jax_runs = {name: run_jax(name, g) for name, g in grads.items()}
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"four-rank gloo run did not finish in {TIMEOUT_S} s")
    port = []
    for o in outs:
        with np.load(o) as data:
            port.append({k: data[k] for k in data.files})
    return port, jax_runs


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def _assert_steps_equal(name, port, jax_runs):
    """Every step, every rank: bit for bit, but the parameters from the
    first dense step on (atol 1e-6: the all-reduce's summation order) and
    the ring's norms (the telemetry tests' tolerances)."""
    from test_torch_telemetry import assert_ring_equal

    ref, _ = jax_runs[name]
    dense_from = next((s + 1 for s, w in enumerate(ref) if w["fallback"]),
                      len(ref))
    for s, want in enumerate(ref):
        for r in range(WORLD):
            got = port[r]
            label = f"{name} step {s} rank {r}"
            for n in SHAPES:
                if s < dense_from:
                    np.testing.assert_array_equal(
                        _bits(got[f"{name}/{s}/param/{n}"]),
                        _bits(want["params"][n][r]), err_msg=f"{label} {n}")
                else:
                    np.testing.assert_allclose(
                        got[f"{name}/{s}/param/{n}"], want["params"][n][r],
                        rtol=0, atol=1e-6, err_msg=f"{label} {n}")
            np.testing.assert_array_equal(got[f"{name}/{s}/counters"],
                                          want["counters"], err_msg=label)
            assert list(got[f"{name}/{s}/audit"]) == want["audit"], label
            assert bool(got[f"{name}/{s}/fallback"]) == want["fallback"], \
                label
            for i, m in enumerate(want["mem"]):
                np.testing.assert_array_equal(
                    _bits(got[f"{name}/{s}/mem/{i}"]), _bits(m[r]),
                    err_msg=f"{label} residual {i}")
            assert_ring_equal(got[f"{name}/{s}/rings"],
                              got[f"{name}/{s}/steps"], want["rings"][r],
                              want["steps"][r], case="escape_window",
                              world=WORLD)


# -- masked broadcast -----------------------------------------------------------

def test_masked_broadcast_bit_exact_at_four_ranks(four_ranks):
    port, _ = four_ranks
    want = _broadcast_cases(3)
    for r in range(WORLD):
        for k, v in want.items():
            np.testing.assert_array_equal(
                port[r][f"bcast/{k}"],
                v.view(-1).view(torch.uint8).numpy(), err_msg=f"{k} rank {r}")


def test_masked_broadcast_is_the_identity_at_one_rank(group):
    x = torch.tensor([-0.0, float("nan"), 3.0])
    x.view(torch.int32)[1] = 0x7FC00321
    for t in (x, torch.tensor([True, False]),
              torch.tensor([-7, 9], dtype=torch.int64),
              torch.tensor([1.5, -0.0], dtype=torch.bfloat16)):
        out = masked_broadcast(t, 0, group)
        assert out.data_ptr() != t.data_ptr()
        assert torch.equal(out.view(-1).view(torch.uint8),
                           t.view(-1).view(torch.uint8))


# -- the fingerprint ------------------------------------------------------------

def _fingerprint_leaves():
    rng = np.random.default_rng(0)
    f = rng.standard_normal(1000).astype(np.float32)
    f[3] = -0.0
    f[5] = np.nan
    f.view(np.uint32)[7] = 0x7FC00123
    return [f, rng.standard_normal(37).astype(np.float32),
            rng.integers(-2**31, 2**31 - 1, 50).astype(np.int32),
            rng.random(13) > 0.5, np.zeros((0,), np.float32),
            rng.standard_normal(11),
            rng.standard_normal((3, 5)).astype(np.float32)]


def _to_jax(leaves):
    out = [jnp.asarray(a) for a in leaves]
    out[1] = out[1].astype(jnp.bfloat16)
    return out


def _to_torch(leaves):
    out = [torch.from_numpy(np.array(a)) for a in leaves]
    out[1] = out[1].to(torch.bfloat16)
    return out


def _assert_fingerprints_equal(got, want, segments):
    got = got.numpy().astype(np.uint32)
    want = np.asarray(want)
    np.testing.assert_array_equal(got[:segments], want[:segments])
    np.testing.assert_allclose(got[segments:].view(np.float32),
                               want[segments:].view(np.float32), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("segments", [8, 3])
def test_fingerprint_words_equal_jax(segments):
    leaves = _fingerprint_leaves()
    with jax.enable_x64(True):     # float64 stays float64
        want = jax_fingerprint_tree(_to_jax(leaves), segments)
    _assert_fingerprints_equal(fingerprint_tree(_to_torch(leaves), segments),
                               want, segments)


def test_fingerprint_chunked_stream_equals_jax(monkeypatch):
    """Chunks of 64 words: leaves split across chunks, chunks of many
    leaves; the same words."""
    monkeypatch.setattr(consensus_mod, "_CHUNK", 64)
    consensus_mod._plan.cache_clear()
    consensus_mod._piece_tables.cache_clear()
    leaves = _fingerprint_leaves()
    with jax.enable_x64(True):
        want = jax_fingerprint_tree(_to_jax(leaves), 8)
    try:
        _assert_fingerprints_equal(fingerprint_tree(_to_torch(leaves), 8),
                                   want, 8)
    finally:
        consensus_mod._plan.cache_clear()
        consensus_mod._piece_tables.cache_clear()


def test_fingerprint_sensitivity():
    w = torch.linspace(-1, 1, 64)
    n = torch.tensor(3, dtype=torch.int32)
    base = fingerprint_tree([w, n])
    assert torch.equal(base, fingerprint_tree([w + 0, n]))

    def variant(**kw):
        return fingerprint_tree([kw.get("w", w), kw.get("n", n)])

    bumped = w.clone()
    bumped[7] += 1e-3
    zero = w.clone()
    zero[0] = -0.0
    zz = torch.zeros_like(w)
    negz = torch.zeros_like(w)
    negz[5] = -0.0
    perm = w.clone()
    perm[[0, 1]] = w[[1, 0]]
    for v in (variant(w=bumped), variant(w=zero), variant(w=zz),
              variant(n=torch.tensor(4, dtype=torch.int32)),
              variant(w=perm)):
        assert not torch.equal(base, v)
    assert not torch.equal(variant(w=zz), variant(w=negz))


def test_replicated_view_leaves_out_the_per_rank_state(group):
    chain = guarded_chain(grace_from_params(CFG, group=group))
    ps = {n: torch.nn.Parameter(torch.zeros(s)) for n, s in SHAPES.items()}
    st = chain.init(ps)
    leaves = replicated_view((ps, st))
    # 4 parameters, 5 guard counters, one tensor of the GraceState's host
    # fields (count, seed, fallback and the audit's five counters).
    assert len(leaves) == 4 + 5 + 1
    assert leaves[-1].tolist() == [0, 0, 0, 0, 0, 0, -1, -1]
    assert not any(t is m for t in leaves for m in st.inner.mem)


# -- four ranks against JAX -------------------------------------------------------

def test_bitflip_repaired_equal_jax(four_ranks):
    port, jax_runs = four_ranks
    _assert_steps_equal("repair", port, jax_runs)
    ref, injections = jax_runs["repair"]
    for r in range(WORLD):
        np.testing.assert_array_equal(port[r]["repair/injections"],
                                      np.array(injections))
    assert ref[-1]["audit"] == [3, 1, 0, 1, 8]
    # Diverged from the flip (before step 5) until the audit after step 7.
    for s in (5, 6):
        assert not np.array_equal(_bits(port[0][f"repair/{s}/param/h1"]),
                                  _bits(port[1][f"repair/{s}/param/h1"])) \
            or not all(np.array_equal(_bits(port[0][f"repair/{s}/param/{n}"]),
                                      _bits(port[1][f"repair/{s}/param/{n}"]))
                       for n in SHAPES)
    for s in range(7, 12):
        for r in range(1, WORLD):
            for n in SHAPES:
                np.testing.assert_array_equal(
                    _bits(port[0][f"repair/{s}/param/{n}"]),
                    _bits(port[r][f"repair/{s}/param/{n}"]))


def test_repair_zeroes_only_the_divergent_ranks_residuals(four_ranks):
    port, _ = four_ranks
    mems = [[port[r][f"repair/7/mem/{i}"] for i in range(len(SHAPES))]
            for r in range(WORLD)]
    assert all(not m.any() for m in mems[1])
    for r in (0, 2, 3):
        assert all(m.any() for m in mems[r])


def test_audit_bytes_equal_jax(four_ranks):
    """The ring's audit rows: 256 B of fingerprints a step, 833 B more on
    the repair (the replicated view at JAX's widths)."""
    port, _ = four_ranks
    rings = port[0]["repair/11/rings"]
    audit = rings[:12, 8]
    want = np.zeros(12, np.float32)
    want[[3, 7, 11]] = 256.0
    want[7] += 833.0
    np.testing.assert_array_equal(audit, want)
    np.testing.assert_array_equal(rings[:12, 5] - rings[1, 5], audit)


def test_escalation_opens_the_dense_window_on_jaxs_step(four_ranks):
    port, jax_runs = four_ranks
    _assert_steps_equal("escalate", port, jax_runs)
    ref, _ = jax_runs["escalate"]
    flags = [w["fallback"] for w in ref]
    assert ref[-1]["audit"][:3] == [5, 2, 1] and any(flags)
    got = [bool(port[0][f"escalate/{s}/fallback"]) for s in range(len(ref))]
    assert got == flags


def test_healthy_run_bit_identical_audit_on_vs_off(four_ranks):
    port, _ = four_ranks
    for r in range(WORLD):
        assert port[r]["healthy"].tolist() == [1, 4, 0, 1]


# -- the rest ---------------------------------------------------------------------

@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


def test_consensus_config_normalization():
    assert normalize_consensus(None) is None
    assert normalize_consensus(False) is None
    assert normalize_consensus(True) == ConsensusConfig()
    assert normalize_consensus(7).audit_every == 7
    assert normalize_consensus({"audit_every": 3, "segments": 2}) == \
        ConsensusConfig(audit_every=3, segments=2)
    with pytest.raises(ValueError, match="audit_every must be >= 1"):
        ConsensusConfig(audit_every=0)
    with pytest.raises(ValueError, match="set together"):
        ConsensusConfig(escalate_window=4)
    with pytest.raises(TypeError):
        normalize_consensus("yes")
    with pytest.raises(ValueError, match="audit_every must be >= 1"):
        grace_from_params({**CFG, "consensus": 0})


def test_consensus_requires_an_armed_state(group):
    cfg = {k: v for k, v in CFG.items() if k != "consensus"}
    chain = guarded_chain(grace_from_params(cfg, group=group))
    ps = {n: torch.nn.Parameter(torch.zeros(s)) for n, s in SHAPES.items()}
    with pytest.raises(ValueError, match="AuditState"):
        consensus_step((ps, chain.init(ps)), ConsensusConfig(audit_every=1),
                       group)
    with pytest.raises(ValueError, match="armed consensus config"):
        force_audit((ps, chain.init(ps)), None, group)


def test_chaos_params_picks_jaxs_leaf_element_and_bit():
    """The same (leaf, element, bit) as JAX's injector on the same params
    tree; a miss step is a no-op; only rank ``rank``'s copy changes."""
    params = make_params()
    jstate = JaxTrainState({n: jnp.asarray(a) for n, a in params.items()},
                           None)
    for seed in (9, 11, 13):
        want = JaxChaosParams(rank=0, at_steps=(2, 4), seed=seed)
        got = ChaosParams(rank=0, at_steps=(2, 4), seed=seed)
        model = torch.nn.ParameterDict(
            {n: torch.nn.Parameter(torch.from_numpy(a.copy()))
             for n, a in params.items()})
        state = TrainState(model, None, None)
        for step in range(5):
            want(jstate, step)
            assert got(state, step) is state
        assert got.injections == want.injections
        flipped = {n: a.copy() for n, a in params.items()}
        for _, li, pos, bit in got.injections:
            flipped[sorted(params)[li]].reshape(-1).view(np.uint32)[pos] ^= \
                np.uint32(1 << bit)
        for n, a in flipped.items():
            np.testing.assert_array_equal(_bits(model[n].detach().numpy()),
                                          _bits(a))


def test_chaos_params_leaves_other_ranks_alone(group):
    model = torch.nn.ParameterDict({"w": torch.nn.Parameter(torch.ones(8))})
    chaos = ChaosParams(rank=1, at_steps=(0,), group=group)
    with pytest.raises(ValueError, match="only 1 ranks"):
        chaos(TrainState(model, None, None), 0)


def test_consensus_monitor_transitions():
    lines, recs = [], []

    class _Sink:
        def write(self, r):
            recs.append(dict(r))

    mon = ConsensusMonitor(
        printer=lambda *a: lines.append(" ".join(map(str, a))),
        sink=_Sink())
    base = {"audits": 1, "repairs": 0, "escalations": 0,
            "last_divergent_rank": -1, "last_repair_step": -1}
    mon.update(0, {})
    mon.update(1, base)
    mon.update(2, dict(base, audits=2))
    mon.update(3, dict(base, audits=3, repairs=1, last_divergent_rank=4))
    mon.update(4, dict(base, audits=4, repairs=2, escalations=1,
                       last_divergent_rank=4))
    assert len(lines) == 3
    assert [r["event"] for r in recs] == [
        "consensus_repair", "consensus_repair", "consensus_escalation"]


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.h = torch.nn.Parameter(torch.randn(8, 16, generator=gen) * 0.3)
        self.w = torch.nn.Parameter(torch.randn(16, 3, generator=gen) * 0.3)

    def forward(self, x):
        return torch.tanh(x @ self.h) @ self.w


def test_train_step_hook_audits_on_the_guard_clock(group):
    """``make_train_step(consensus=...)``: audits after every second guard
    step, skipped steps included; ``audit_report`` reads host values."""
    from grace_tpu_torch.train import init_train_state, make_train_step

    model = _Net()
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    chain = guarded_chain(grace_from_params(CFG, group=group))
    state = init_train_state(model, chain, opt, group)
    step = make_train_step(
        lambda m, b: torch.nn.functional.cross_entropy(m(b[0]), b[1]),
        chain, group, consensus=ConsensusConfig(audit_every=2))
    gen = torch.Generator().manual_seed(1)
    batch = (torch.randn(32, 8, generator=gen),
             torch.randint(0, 3, (32,), generator=gen))
    bad = [False]

    def poison(g):
        return g * float("nan") if bad[0] else g

    model.h.register_hook(poison)
    audits = []
    for i in range(6):
        bad[0] = i == 2
        state, _ = step(state, batch)
        audits.append(audit_report(state)["audits"])
    assert audits == [0, 1, 1, 2, 2, 3]
    assert state.grace.inner.count == 5 and state.grace.host_step == 6


def test_checkpoint_carries_the_audit(group, tmp_path):
    from grace_tpu_torch.checkpoint import Checkpointer

    chain = guarded_chain(grace_from_params(CFG, group=group))
    ps = {n: torch.nn.Parameter(torch.zeros(s)) for n, s in SHAPES.items()}
    st = chain.init(ps)
    st = st.replace(inner=dataclasses.replace(
        st.inner, audit=AuditState(4, 1, 0, 2, 8)))
    with Checkpointer(tmp_path / "ck", max_to_keep=None) as ckpt:
        ckpt.save(0, {"grace": st}, force=True)
        back = ckpt.restore({"grace": chain.init(ps)})
        assert back["grace"].inner.audit == AuditState(4, 1, 0, 2, 8)
        assert back["grace"].host_step == 0
        replicated = torch.load(tmp_path / "ck" / "0" / "replicated.pt",
                                weights_only=False)
        assert replicated["grace/inner/audit/repairs"] == 1
        plain = guarded_chain(grace_from_params(
            {k: v for k, v in CFG.items() if k != "consensus"}, group=group))
        with pytest.raises(ValueError, match="grace/inner/audit"):
            ckpt.restore({"grace": plain.init(ps)})


def test_convert_carries_a_jax_audit_state():
    from grace_tpu.transform import AuditState as JaxAuditState

    from grace_tpu_torch.convert import grace_state_from_jax
    jstate = jax_grace_from_params(CFG).transform(seed=1).init(
        {n: jnp.zeros(s) for n, s in SHAPES.items()})
    jstate = jstate._replace(audit=JaxAuditState(
        *(jnp.asarray(v, jnp.int32) for v in (3, 1, 1, 2, 6))))
    got = grace_state_from_jax(jax.device_get(jstate), seed=1)
    assert got.audit == AuditState(3, 1, 1, 2, 6)
