"""The port's elastic resize against the JAX package's, on the CPU.

* Planning: ``Topology.shrink`` and ``plan_resize`` (whole slices, partial
  losses, flat layouts, regions) equal JAX's; the hier communicator's
  ``shrunk``.
* At four gloo ranks against JAX's four-device mesh, a guarded Top-K run
  with escape, consensus, telemetry and watch (JAX's elastic fixture
  config), four healthy steps and one the guard skips, then a re-shard
  4 → 3 (rank 3 leaves) against JAX's onto a three-device mesh: the
  replicated fields (``count``, ``fallback``, ``audit``), the guard's
  counters and the parameters bit for bit; the residuals zero; the rings
  reset at their capacity; ``validate_resharded``'s integers JAX's, and
  its error at the wrong world; the departed rank gets None; the wrong
  old group raises; the re-sharded state trains. PowerSGD's Q freshly
  drawn, equal to JAX's re-init. An adaptive controller re-initialized.
* The rejoin barrier at four ranks: a stale replica on rank 3 repaired bit
  for bit with its residuals zeroed (the fleet's kept), one repair, one
  replica variant, JAX's report (divergent rank, fingerprint and repair
  bytes); a consistent rejoin repairs nothing.
* The ``chaos_smoke --elastic`` lifecycle at four ranks: drift on rank 2 →
  watch anomaly → drain (last-known-good) → resize 4 → 3 → training →
  grow back to 4 with the drained rank restored from its checkpoint →
  barrier: repairs == rejoins, replicas bit-identical, footprints at both
  worlds, the events in the sink, classified ``elastic``.
* The controller's thresholds, region scope and drain watchdog, the
  topology detected once at build (over the communicator's group).
"""

import dataclasses
import json
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
from grace_tpu.core import Topology as JaxTopology
from grace_tpu.resilience import ConsensusConfig as JaxConsensusConfig
from grace_tpu.resilience import ElasticController as JaxElasticController
from grace_tpu.resilience import guarded_chain as jax_guarded_chain
from grace_tpu.resilience import implant_stale_replica as jax_implant
from grace_tpu.resilience import plan_resize as jax_plan_resize
from grace_tpu.resilience import rejoin_barrier as jax_rejoin_barrier
from grace_tpu.resilience import reshard_grace_state as jax_reshard
from grace_tpu.resilience import validate_resharded as jax_validate
from grace_tpu.train import TrainState as JaxTrainState
from grace_tpu.train import _lazy_sharded_step, init_train_state
from grace_tpu.transform import add_world_axis, strip_world_axis

from grace_tpu_torch import grace_from_params
from grace_tpu_torch.core import Topology
from grace_tpu_torch.resilience import (ConsensusConfig, ElasticController,
                                        adapt_report, guarded_chain,
                                        implant_stale_replica, plan_resize,
                                        rejoin_barrier, reshard_grace_state,
                                        resize_group, validate_resharded)
from grace_tpu_torch.train import TrainState

WORLD = 4
LOST = 3
TIMEOUT_S = 240
LR = 0.25
SHAPES = {"b": (4,), "w": (16, 4)}
# JAX's elastic fixture config (tests/test_elastic.py:43-47), with the chunk
# algorithm, whose selection the two packages make bit for bit.
GRACE = {"compressor": "topk", "compress_ratio": 0.25,
         "topk_algorithm": "chunk", "memory": "residual",
         "communicator": "allgather", "escape": "fp16",
         "consensus": {"audit_every": 50}, "telemetry": 8,
         "watch": {"window": 2, "capacity": 4}}
GUARD = {"fallback_after": 3, "fallback_steps": 4}
POWERSGD = {"compressor": "powersgd", "compress_rank": 2,
            "memory": "powersgd", "communicator": "allreduce"}
ADAPTIVE = {**{k: v for k, v in GRACE.items() if k != "watch"},
            "adapt": {"window": 2, "ladder": [{"compress_ratio": 0.5}],
                      "tighten_error": 1e-6, "tighten_peak": 1e-6,
                      "loosen_error": 1e-7}}
STEPS = 5                      # four healthy, then one the guard skips
BAD_STEP = 4
FOOTPRINT = ("grace_states", "mem_bytes", "comp_bytes", "telem_bytes",
             "bookkeeping_bytes", "total_bytes")


def make_grads(steps, seed=0):
    rng = np.random.default_rng(seed)
    g = {n: (rng.standard_normal((WORLD, steps) + s) * 0.5).astype(
        np.float32) for n, s in SHAPES.items()}
    if steps > BAD_STEP:
        g["w"][0, BAD_STEP, 0, 0] = np.nan
    return g


def make_params():
    return {"b": np.zeros((4,), np.float32), "w": np.ones((16, 4),
                                                           np.float32)}


def _jax_cfg(cfg):
    cfg = dict(cfg)
    if isinstance(cfg.get("consensus"), dict):
        cfg["consensus"] = JaxConsensusConfig(**cfg["consensus"])
    return cfg


# -- JAX's side --------------------------------------------------------------------

def _jax_run(cfg, grads, steps):
    """JAX's guarded chain on a four-device mesh over fixed gradients."""
    grc = jax_grace_from_params(_jax_cfg(cfg))
    tx = jax_guarded_chain(grc, optax.sgd(LR), **GUARD)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    state = init_train_state({n: jnp.asarray(a)
                              for n, a in make_params().items()}, tx, mesh)

    def device_step(st, batch):
        g = jax.tree.map(lambda a: a[0], batch)
        opt = strip_world_axis(st.opt_state)
        updates, opt = tx.update(g, opt, st.params)
        return (JaxTrainState(optax.apply_updates(st.params, updates),
                              add_world_axis(opt)), jnp.zeros(()))

    step = _lazy_sharded_step(device_step, mesh, "data", donate=False)
    for s in range(steps):
        state, _ = step(state, {n: jnp.asarray(a[:, s])
                                for n, a in grads.items()})
    return grc, tx, mesh, state


def _first(x):
    return np.asarray(x).reshape(-1)[0].item()


def jax_reference(grads, psgd_grads) -> dict:
    grc, tx, mesh, state = _jax_run(GRACE, grads, STEPS)
    mesh3 = Mesh(np.array(jax.devices()[:WORLD - 1]), ("data",))
    new = jax_reshard(state, tx, mesh, mesh3)
    g = new.opt_state.inner[0]
    guard = new.opt_state
    out = {"count": _first(g.count), "fallback": _first(g.fallback),
           "audit": [_first(v) for v in g.audit],
           "counters": [_first(getattr(guard, f)) for f in (
               "notfinite_count", "last_bad_step", "consecutive",
               "fallback_remaining", "step")],
           "params": {n: np.asarray(jax.device_get(v))
                      for n, v in new.params.items()},
           "telem_steps": np.asarray(g.telem.steps),
           "watch_steps": np.asarray(g.watch.steps),
           "mem_shapes": [tuple(np.shape(m)) for m in g.mem],
           "validate": jax_validate(new, grc, make_params(), 3)}
    with pytest.raises(ValueError, match="footprint model at world 4"):
        jax_validate(new, grc, make_params(), 4)
    _, ptx, pmesh, pstate = _jax_run(POWERSGD, psgd_grads, 1)
    pnew = jax_reshard(pstate, ptx, pmesh, mesh3)
    out["powersgd_q"] = [None if q is None else np.asarray(q)[0]
                         for q in pnew.opt_state.inner[0].comp]
    # The rejoin barrier: one step, stale params, three more, implant.
    grc, tx, mesh, state = _jax_run(GRACE, grads, 1)
    stale = jax.device_get(state.params)
    step_grads = {n: a[:, 1:4] for n, a in grads.items()}
    _, _, _, state = _jax_run_from(tx, mesh, state, step_grads, 3)
    state = jax_implant(state, LOST, stale)
    state, rep = jax_rejoin_barrier(state, JaxConsensusConfig(
        **GRACE["consensus"]), mesh)
    out["rejoin"] = {k: rep[k] for k in (
        "barrier_repairs", "replica_variants", "last_divergent_rank",
        "fingerprint_bytes", "repair_bytes", "audits", "repairs")}
    out["rejoin_params"] = {n: np.asarray(jax.device_get(v))
                            for n, v in state.params.items()}
    return out


def _jax_run_from(tx, mesh, state, grads, steps):
    def device_step(st, batch):
        g = jax.tree.map(lambda a: a[0], batch)
        opt = strip_world_axis(st.opt_state)
        updates, opt = tx.update(g, opt, st.params)
        return (JaxTrainState(optax.apply_updates(st.params, updates),
                              add_world_axis(opt)), jnp.zeros(()))

    step = _lazy_sharded_step(device_step, mesh, "data", donate=False)
    for s in range(steps):
        state, _ = step(state, {n: jnp.asarray(a[:, s])
                                for n, a in grads.items()})
    return None, tx, mesh, state


# -- the port's side ------------------------------------------------------------------

def _port_run(cfg, grads, steps, group, rank, state=None, chain=None):
    """The guarded chain in the port over this rank's fixed gradients."""
    if state is None:
        chain = guarded_chain(grace_from_params(cfg, group=group), **GUARD)
        ps = {n: torch.nn.Parameter(torch.from_numpy(a))
              for n, a in make_params().items()}
        model = torch.nn.ParameterDict(ps)
        opt = torch.optim.SGD(model.parameters(), lr=LR)
        state = TrainState(model, opt, chain.init(ps))
    ps = dict(state.model.named_parameters())
    for s in range(steps):
        grace = chain.apply(ps, {n: torch.from_numpy(a[rank, s].copy())
                                 for n, a in grads.items()},
                            state.grace, state.optimizer)
        state = TrainState(state.model, state.optimizer, grace)
    return chain, state


def _reshard_worker(group, rank, grads, psgd_grads) -> dict:
    out = {}
    chain, state = _port_run(GRACE, grads, STEPS, group, rank)
    old = state.grace.inner
    out["old_mem_nonzero"] = bool(any(float(m.abs().sum()) > 0
                                      for m in old.mem))
    plan = plan_resize(WORLD, [LOST])
    ng = resize_group(plan)
    grace3 = (grace_from_params(GRACE, group=ng) if ng is not None
              else None)
    chain3 = guarded_chain(grace3, **GUARD) if ng is not None else None
    new = reshard_grace_state(state, chain3, None, ng)
    out["departed"] = new is None
    if new is not None:
        g = new.grace.inner
        out.update(
            count=g.count, fallback=g.fallback, audit=list(g.audit),
            world=g.world, counters=new.grace.counters().tolist(),
            params={n: p.detach().numpy().copy()
                    for n, p in new.model.named_parameters()},
            mem_zero=all(float(m.abs().sum()) == 0 for m in g.mem),
            mem_shapes=[tuple(m.shape) for m in g.mem],
            telem_steps=g.telem.steps.numpy().copy(),
            telem_zero=float(g.telem.rings.abs().sum()) == 0,
            watch_steps=g.watch.steps.numpy().copy(),
            watch_zero=float(g.watch.rings.abs().sum()) == 0,
            validate=validate_resharded(new, grace3, None, 3))
        try:
            validate_resharded(new, grace3, None, 4)
            out["wrong_world"] = ""
        except ValueError as e:
            out["wrong_world"] = str(e)
        try:
            reshard_grace_state(state, chain3, ng, ng)
            out["wrong_group"] = ""
        except ValueError as e:
            out["wrong_group"] = str(e)
        # The re-sharded state trains at three ranks.
        _, trained = _port_run(GRACE, {n: a[:, :2] for n, a in
                                       make_grads(2, seed=9).items()},
                               2, ng, rank, new, chain3)
        out["trained_count"] = trained.grace.inner.count
        out["trained_finite"] = all(
            bool(torch.isfinite(p).all())
            for p in trained.model.parameters())
    # PowerSGD: Q re-drawn, not zeroed.
    pchain, pstate = _port_run(POWERSGD, psgd_grads, 1, group, rank)
    pchain3 = (guarded_chain(grace_from_params(POWERSGD, group=ng), **GUARD)
               if ng is not None else None)
    pnew = reshard_grace_state(pstate, pchain3, None, ng)
    if pnew is not None:
        out["powersgd_q"] = [None if q is None else q.numpy().copy()
                             for q in pnew.grace.inner.comp]
    # An adaptive controller moves, then the resize re-initializes it.
    achain, astate = _port_run(ADAPTIVE, grads, 4, group, rank)
    out["adapt_before"] = adapt_report(astate)
    achain3 = (guarded_chain(grace_from_params(ADAPTIVE, group=ng), **GUARD)
               if ng is not None else None)
    anew = reshard_grace_state(astate, achain3, None, ng)
    if anew is not None:
        out["adapt_after"] = adapt_report(anew)
        out["adapt_count"] = anew.grace.inner.count
    if ng is not None:
        torch.distributed.destroy_process_group(ng)
    return out


def _rejoin_worker(group, rank, grads) -> dict:
    out = {}
    chain, state = _port_run(GRACE, grads, 1, group, rank)
    stale = {n: p.detach().clone()
             for n, p in state.model.named_parameters()}
    _, state = _port_run(GRACE, {n: a[:, 1:4] for n, a in grads.items()},
                         3, group, rank, state, chain)
    state = implant_stale_replica(state, LOST, stale, group)
    state, rep = rejoin_barrier(state, GRACE["consensus"], group)
    out["rejoin"] = {k: rep[k] for k in (
        "barrier_repairs", "replica_variants", "last_divergent_rank",
        "fingerprint_bytes", "repair_bytes", "audits", "repairs")}
    out["params"] = {n: p.detach().numpy().copy()
                     for n, p in state.model.named_parameters()}
    out["mem_zero"] = all(float(m.abs().sum()) == 0
                          for m in state.grace.inner.mem)
    # A consistent rejoin: nothing to repair, nothing changes.
    before = [t.clone() for t in state.model.parameters()] + \
        [m.clone() for m in state.grace.inner.mem]
    state, rep = rejoin_barrier(state, GRACE["consensus"], group)
    after = list(state.model.parameters()) + list(state.grace.inner.mem)
    out["noop"] = [rep["barrier_repairs"], rep["replica_variants"],
                   all(torch.equal(a, b) for a, b in zip(before, after))]
    return out


DRIFT_RANK = 2
LC_WINDOW = 2


def _lifecycle_worker(group, rank, ckpt_dir) -> dict:
    """JAX's ``chaos_smoke --elastic`` at four ranks (a small MLP): drift on
    rank 2 until the watch names it, drain, resize 4 → 3 (rank 2 leaves and
    waits), three steps at three, grow back: the survivors re-shard onto
    the four-rank group, rank 2 restores its drained checkpoint (a stale
    replica), and the barrier repairs it."""
    from grace_tpu_torch.checkpoint import Checkpointer
    from grace_tpu_torch.resilience import ChaosCompressor
    from grace_tpu_torch.telemetry import TelemetryReader
    from grace_tpu_torch.telemetry.timeline import Timeline
    from grace_tpu_torch.train import init_train_state, make_train_step

    cfg = {"compressor": "topk", "compress_ratio": 0.3,
           "topk_algorithm": "chunk", "memory": "residual",
           "communicator": "allgather", "escape": "fp16",
           "consensus": {"audit_every": 10}, "telemetry": 16,
           "watch": {"window": LC_WINDOW, "capacity": 8}}
    consensus = ConsensusConfig(audit_every=10)

    def build(g, drift=False):
        grc = grace_from_params(cfg, group=g)
        if drift:
            grc = dataclasses.replace(grc, compressor=ChaosCompressor(
                inner=grc.compressor, drift_scale=0.9, rank=DRIFT_RANK,
                seed=3, group=g))
        return grc, guarded_chain(grc, **GUARD)

    rng = np.random.default_rng(0)
    init = {"w1": rng.normal(scale=0.3, size=(12, 12)).astype(np.float32),
            "b1": np.zeros(12, np.float32),
            "w2": rng.normal(scale=0.3, size=(12, 3)).astype(np.float32)}
    images = rng.normal(size=(64, 12)).astype(np.float32)
    labels = rng.integers(0, 3, size=64)

    def loss_fn(m, b):
        x, y = b
        h = torch.tanh(x @ m["w1"] + m["b1"])
        return torch.nn.functional.cross_entropy(h @ m["w2"], y)

    def at(i, r, w):
        lo = (i * 16) % 48
        per = 16 // w
        part = slice(lo + r * per, lo + (r + 1) * per)
        return (torch.from_numpy(images[part]),
                torch.from_numpy(labels[part]))

    records = []

    class Sink:
        def write(self, rec):
            records.append(dict(rec))

    sink = Sink()
    ckpt = Checkpointer(ckpt_dir, max_to_keep=2)
    ctl = ElasticController(consensus=consensus, checkpointer=ckpt,
                            sink=sink, anomaly_threshold=1, group=group)
    reader = TelemetryReader(sink, every=LC_WINDOW, anomaly=True)
    model = torch.nn.ParameterDict(
        {n: torch.nn.Parameter(torch.from_numpy(a)) for n, a in
         init.items()})
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    grc, tx = build(group, drift=True)
    state = init_train_state(model, tx, opt, group)
    step = make_train_step(loss_fn, tx, group, consensus=consensus)
    drain = None
    seen = 0
    for i in range(8):
        state, loss = step(state, at(i, rank, WORLD))
        reader.update(i, state)
        anomalies = reader.monitor.anomalies
        flagged = ctl.observe(i, anomalies[seen:])
        seen = len(anomalies)
        if flagged is not None and drain is None:
            drain = (flagged, i)
    # The drain's save is a collective: every rank takes it at one step.
    ctl.drain(7, state, drain[0] if drain else DRIFT_RANK)
    plan = plan_resize(WORLD, [DRIFT_RANK])
    ng = resize_group(plan)
    footprint = {}
    steps_b = 3
    if ng is not None:
        grc3, tx3 = build(ng)
        state, ev = ctl.resize(8, state, tx3, None, ng, plan, grace=grc3)
        footprint[3] = ev["footprint_matches"]
        step3 = make_train_step(loss_fn, tx3, ng, consensus=consensus)
        r3 = plan.survivors.index(rank)
        for i in range(8, 8 + steps_b):
            state, loss = step3(state, at(i, r3, 3))
    else:
        ctl.resize(8, state, None, None, None, plan)
    torch.distributed.barrier()
    # Grow back: every rank builds the four-rank chain.
    grc4, tx4 = build(group)
    grow = dataclasses.replace(plan_resize(WORLD, []), old_world=3)
    if ng is not None:
        state, ev = ctl.resize(8 + steps_b, state, tx4, ng, group, grow,
                               grace=grc4)
        footprint[4] = ev["footprint_matches"]
        torch.distributed.destroy_process_group(ng)
    else:
        target = TrainState(model, opt, tx4.init(
            dict(model.named_parameters())))
        state = ckpt.restore_last_good(target)
    state, barrier = ctl.rejoin(8 + steps_b, state, group)
    tl = Timeline.from_records(records)
    variants = barrier["replica_variants"]
    params = [p.detach().numpy().copy() for p in model.parameters()]
    return {"drain": list(drain) if drain else None, "footprint": footprint,
            "barrier_repairs": barrier["barrier_repairs"],
            "variants": variants,
            "divergent": barrier["last_divergent_rank"],
            "events": [e["event"] for e in ctl.events],
            "elastic_kinds": tl.summary()["kind_counts"].get("elastic", 0),
            "loss": float(loss), "params": [p.tolist() for p in params]}


def _worker(rank, init_file, paths, ckpt_dir, out_paths):
    from grace_tpu_torch.parallel import init_process_group

    group, _ = init_process_group("cpu", rank=rank, world_size=WORLD,
                                  init_method=f"file://{init_file}")
    torch.set_num_threads(1)
    try:
        grads = dict(np.load(paths["grads"]))
        psgd = dict(np.load(paths["psgd"]))
        out = {"reshard": _reshard_worker(group, rank, grads, psgd),
               "rejoin": _rejoin_worker(group, rank, grads),
               "lifecycle": _lifecycle_worker(group, rank, ckpt_dir)}
        torch.save(out, out_paths[rank])
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    grads = make_grads(STEPS, seed=0)
    psgd = make_grads(1, seed=1)
    paths = {"grads": str(tmp / "grads.npz"), "psgd": str(tmp / "psgd.npz")}
    np.savez(paths["grads"], **grads)
    np.savez(paths["psgd"], **psgd)
    outs = [str(tmp / f"rank{r}.pt") for r in range(WORLD)]
    ctx = mp.start_processes(
        _worker, args=(str(tmp / "store"), paths, str(tmp / "ck"), outs),
        nprocs=WORLD, join=False, start_method="spawn")
    ref = jax_reference(grads, psgd)
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"four-rank gloo run did not finish in {TIMEOUT_S} s")
    return [torch.load(o, weights_only=False) for o in outs], ref


# -- the re-shard ---------------------------------------------------------------------

def _survivors(port):
    return [port[r]["reshard"] for r in range(WORLD) if r != LOST]


def test_departed_rank_gets_none(four_ranks):
    port, _ = four_ranks
    assert port[LOST]["reshard"]["departed"]
    assert not any(s["departed"] for s in _survivors(port))


def test_replicated_fields_and_params_carry_bit_for_bit(four_ranks):
    port, ref = four_ranks
    for s in _survivors(port):
        assert s["count"] == ref["count"] == BAD_STEP
        assert s["fallback"] == bool(ref["fallback"])
        assert s["audit"] == ref["audit"]
        assert s["counters"] == ref["counters"]
        assert s["counters"][0] == 1               # the skipped step
        for n in SHAPES:
            np.testing.assert_array_equal(
                s["params"][n].view(np.uint8),
                np.ascontiguousarray(ref["params"][n]).view(np.uint8))


def test_residuals_zeroed_at_the_new_world(four_ranks):
    port, ref = four_ranks
    for r, s in enumerate(port):
        assert s["reshard"]["old_mem_nonzero"], r
    for s in _survivors(port):
        assert s["mem_zero"] and s["world"] == 3
        # JAX's global layout: one row per rank of the new world.
        assert [(3,) + shape for shape in s["mem_shapes"]] == \
            ref["mem_shapes"]


def test_rings_reallocated_and_reset(four_ranks):
    port, ref = four_ranks
    for s in _survivors(port):
        for ring in ("telem", "watch"):
            assert s[f"{ring}_zero"]
            np.testing.assert_array_equal(s[f"{ring}_steps"],
                                          ref[f"{ring}_steps"][0])
            assert (s[f"{ring}_steps"] == -1).all()


def test_validate_resharded_gives_jax_integers(four_ranks):
    port, ref = four_ranks
    for s in _survivors(port):
        got, want = s["validate"], ref["validate"]
        assert got["matches"] and want["matches"]
        for side in ("live", "model"):
            assert {k: got[side][k] for k in FOOTPRINT} == \
                {k: want[side][k] for k in FOOTPRINT}, side
        assert "footprint model at world 4" in s["wrong_world"]


def test_reshard_rejects_the_wrong_old_group(four_ranks):
    port, _ = four_ranks
    for s in _survivors(port):
        assert "world axis 4" in s["wrong_group"]


def test_resharded_state_trains(four_ranks):
    port, _ = four_ranks
    for s in _survivors(port):
        assert s["trained_count"] == s["count"] + 2
        assert s["trained_finite"]


def test_powersgd_comp_reinitialized_not_zeroed(four_ranks):
    port, ref = four_ranks
    for s in _survivors(port):
        qs = [q for q in s["powersgd_q"] if q is not None]
        assert qs
        for q, want in zip(s["powersgd_q"], ref["powersgd_q"]):
            if want is None:
                assert q is None
                continue
            assert float(np.abs(q).sum()) > 0
            np.testing.assert_array_equal(q, want)


def test_adapt_reinitialized_by_the_resize(four_ranks):
    port, _ = four_ranks
    init = {"rung": 2, "tightens": 0, "loosens": 0, "escalations": 0,
            "hold": 0, "quiet": 0, "last_change_step": -1}
    for r, s in enumerate(port):
        before = s["reshard"]["adapt_before"]
        assert before["tightens"] >= 1 and before["rung"] < 2, r
    for s in _survivors(port):
        assert s["adapt_after"] == init
        assert s["adapt_count"] == 4


# -- the rejoin barrier -------------------------------------------------------------

def test_rejoin_barrier_repairs_a_stale_replica(four_ranks):
    port, ref = four_ranks
    for r in range(WORLD):
        got = port[r]["rejoin"]
        assert got["rejoin"] == ref["rejoin"], r
        assert got["rejoin"]["barrier_repairs"] == 1
        assert got["rejoin"]["replica_variants"] == 1
        assert got["rejoin"]["last_divergent_rank"] == LOST
        assert got["rejoin"]["fingerprint_bytes"] == WORLD * 2 * 8 * 4
        # The rejoiner's residuals zeroed; the fleet's kept.
        assert got["mem_zero"] == (r == LOST)
        for n in SHAPES:
            np.testing.assert_array_equal(got["params"][n],
                                          ref["rejoin_params"][n])


def test_consistent_rejoin_repairs_nothing(four_ranks):
    port, _ = four_ranks
    for r in range(WORLD):
        assert port[r]["rejoin"]["noop"] == [0, 1, True]


def test_requires_armed_consensus():
    with pytest.raises(ValueError, match="armed consensus"):
        rejoin_barrier(None, None)
    with pytest.raises(ValueError, match="armed consensus"):
        ElasticController().rejoin(0, None)


# -- the lifecycle --------------------------------------------------------------------

def test_elastic_lifecycle_at_four_ranks(four_ranks):
    port, _ = four_ranks
    docs = [port[r]["lifecycle"] for r in range(WORLD)]
    assert all(d["drain"] == [DRIFT_RANK, docs[0]["drain"][1]] for d in docs)
    for r, d in enumerate(docs):
        assert d["barrier_repairs"] == 1           # repairs == rejoins
        assert d["variants"] == 1
        assert d["divergent"] == DRIFT_RANK
        assert d["params"] == docs[0]["params"]    # bit-identical replicas
        if r == DRIFT_RANK:
            assert d["events"] == ["elastic_drain", "elastic_resize",
                                   "elastic_rejoin"]
        else:
            assert d["footprint"] == {3: True, 4: True}
            assert d["events"] == ["elastic_drain", "elastic_resize",
                                   "elastic_resize", "elastic_rejoin"]
            assert d["elastic_kinds"] == 4
            assert np.isfinite(d["loss"])


# -- planning --------------------------------------------------------------------------

SHRINKS = [
    (Topology(slice_size=4), 8, range(4, 8)),
    (Topology(slice_size=4), 8, [5]),
    (Topology(), 8, [3]),
    (Topology(slice_size=4), 8, []),
    (Topology(slice_size=2, region_size=4), 8, range(4, 8)),
    (Topology(slice_size=2, region_size=4), 8, [2, 3]),
]


@pytest.mark.parametrize("case", range(len(SHRINKS)))
def test_plan_resize_equals_jax(case):
    topo, world, lost = SHRINKS[case]
    jtopo = JaxTopology(slice_size=topo.slice_size,
                        region_size=topo.region_size)
    got = plan_resize(world, lost, topo)
    want = jax_plan_resize(world, lost, jtopo)
    for f in ("old_world", "new_world", "lost_ranks", "survivors",
              "whole_slices", "whole_regions"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.topology.slice_size, got.topology.region_size) == \
        (want.topology.slice_size, want.topology.region_size)


def test_shrink_errors():
    with pytest.raises(ValueError, match="outside the world"):
        Topology().shrink(8, [8])
    with pytest.raises(ValueError, match="no survivors"):
        Topology().shrink(2, [0, 1])
    with pytest.raises(ValueError, match="old group has"):
        resize_group(plan_resize(8, [1]))


def test_hier_communicator_shrunk():
    from grace_tpu_torch.comm import HierarchicalAllreduce

    comm = HierarchicalAllreduce(slice_size=4)
    kept = comm.shrunk(Topology(slice_size=4))
    assert isinstance(kept, HierarchicalAllreduce) and kept.slice_size == 4
    assert comm.shrunk(Topology()).slice_size is None


# -- the controller --------------------------------------------------------------------

def test_drain_signal_thresholds_codec_skew_episodes():
    for ctl in (ElasticController(anomaly_threshold=2),
                JaxElasticController(anomaly_threshold=2)):
        skew = {"kind": "skew", "metric": "compression_error", "rank": 3}
        assert ctl.observe(1, [skew]) is None
        assert ctl.observe(2, [skew]) == 3
        assert ctl.observe(3, [skew, skew]) is None


def test_grad_norm_skews_do_not_drain():
    ctl = ElasticController(anomaly_threshold=1)
    noise = {"kind": "skew", "metric": "grad_norm", "rank": 2}
    ewma = {"kind": "ewma", "metric": "compression_error_mean", "rank": -1}
    assert ctl.observe(1, [noise, ewma]) is None
    assert ctl.observe(2, [{"kind": "skew", "metric": "residual_norm",
                            "rank": 6}]) == 6


def test_region_scope_equals_jax():
    kw = dict(topology=None, anomaly_threshold=1, region_quorum=0.5)
    for topo in (None, (2, 4)):
        ctl = ElasticController(**{**kw, "topology": Topology(
            slice_size=topo[0], region_size=topo[1]) if topo else None})
        jctl = JaxElasticController(**{**kw, "topology": JaxTopology(
            slice_size=topo[0], region_size=topo[1]) if topo else None})
        for c in (ctl, jctl):
            c.observe(0, [{"kind": "skew", "metric": "residual_norm",
                           "rank": r} for r in (5, 6)])
        for rank in (1, 5, 6):
            assert ctl.region_scope(rank) == jctl.region_scope(rank)
    with pytest.raises(ValueError, match="region_quorum"):
        ElasticController(region_quorum=0.0)


def test_drain_saves_last_known_good(tmp_path):
    from grace_tpu_torch.checkpoint import Checkpointer

    with Checkpointer(tmp_path / "ck", max_to_keep=None) as ckpt:
        ctl = ElasticController(checkpointer=ckpt, anomaly_threshold=1)
        rec = ctl.drain(7, {"x": torch.arange(4.0)}, rank=5)
        assert rec["event"] == "elastic_drain" and rec["rank"] == 5
        assert ckpt.last_good_step() == 7
    assert ctl.events[0]["checkpointed"] and 5 in ctl.drained_ranks


def test_drain_watchdog_times_out_and_retries(tmp_path):
    import threading

    release = threading.Event()

    class Stalled:
        def save(self, *a, **k):
            release.wait(5.0)

        def wait(self):
            pass

        def last_good_step(self):
            return 3

    ctl = ElasticController(checkpointer=Stalled(), drain_timeout_s=0.05,
                            drain_retries=1)
    rec = ctl.drain(9, {}, rank=1)
    release.set()
    timeouts = [e for e in ctl.events
                if e["event"] == "elastic_drain_timeout"]
    assert [e["timeout_s"] for e in timeouts] == [0.05, 0.1]
    assert timeouts[0]["last_good_step"] == 3
    assert rec["checkpointed"] is False and rec["drain_timeouts"] == 2
    with pytest.raises(ValueError, match="drain_timeout_s"):
        ElasticController(drain_timeout_s=0)
    with pytest.raises(ValueError, match="drain_retries"):
        ElasticController(drain_retries=-1)


def test_events_stream_into_sink_as_elastic_kind(tmp_path):
    from grace_tpu_torch.telemetry import JSONLSink
    from grace_tpu_torch.telemetry.timeline import Timeline, classify

    path = tmp_path / "e.jsonl"
    sink = JSONLSink(path)
    ctl = ElasticController(sink=sink, anomaly_threshold=1)
    ctl._emit("elastic_resize", 10, old_world=8, new_world=7)
    sink.close()
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert classify(records[-1]) == "elastic"
    assert Timeline.from_records(records).summary()["kind_counts"][
        "elastic"] == 1


# -- the topology, detected once at build ----------------------------------------------

@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


def test_topology_detected_once_at_build_over_the_group(group, monkeypatch):
    calls = []
    orig = Topology.detect.__func__

    def counting(cls, devices=None, group=None):
        if devices is None:        # not the host list's own detection
            calls.append(group)
        return orig(cls, devices, group)

    monkeypatch.setattr(Topology, "detect", classmethod(counting))
    tx = grace_from_params({**GRACE, "consensus": None}, group=group) \
        .transform(seed=0)
    assert calls == [group] and isinstance(tx.topology, Topology)

    def boom(cls, devices=None, group=None):   # pragma: no cover
        raise AssertionError("Topology.detect called after build")

    monkeypatch.setattr(Topology, "detect", classmethod(boom))
    state = tx.init({n: torch.zeros(s) for n, s in SHAPES.items()})
    for _ in range(2):                          # crosses a watch window
        _, state = tx.update({n: torch.ones(s) for n, s in SHAPES.items()},
                             state)
    assert grace_from_params({"compressor": "none", "communicator": "hier",
                              "slice_size": 4, "telemetry": 4},
                             group=group).transform(seed=0) \
        .topology.slice_size == 4
    assert grace_from_params({"compressor": "none",
                              "communicator": "allgather"},
                             group=group).transform(seed=0).topology is None
