"""The port's online re-tuner against the JAX package's, on the CPU.

* The host-side controller: ``observe`` and ``watch`` on one seeded stream
  of compression errors and records give JAX's return sequence and event
  payloads; the knob validation raises where JAX's does; the watchdog is
  bounded, doubles its timeout, records each stall as JAX's does, and
  lets an exception through unretried.
* ``state_digest`` over a dict of tensors equals JAX's hex digest over the
  same numpy arrays (the same dtype names, shapes and bytes, leaf by leaf),
  and changes with one element.
* At W=1 on gloo, JAX's ``OLD_PARAMS``/``NEW_PARAMS`` on the toy MLP
  (``tests/test_retune.py``): PREPARE leaves the incumbent's digest
  unchanged and its migration counts equal JAX's ``staged.migration`` on
  the same incumbent (carried across by ``convert.grace_state_from_jax``);
  promote → quiet probation → clear; promote → ``guard_skip`` → a bit-exact
  demotion after which the incumbent trains; ``prepare`` during probation
  raises; a chain-structure mismatch aborts at ``migrate``; a candidate the
  auditor rejects aborts at ``lint``, its audit run in a child process
  beside the live default group.
* Two gloo ranks: promote → a sabotaged step → demote, with the consensus
  barrier: the replicas bit-identical (one variant) after the commit and
  after the demotion, the demotion bit-exact on both ranks.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh
from torch import nn

from grace_tpu import grace_from_params as jax_grace_from_params
from grace_tpu.core import DEFAULT_AXIS
from grace_tpu.resilience import ConsensusConfig as JaxConsensusConfig
from grace_tpu.resilience import RetuneController as JaxRetuneController
from grace_tpu.resilience import guarded_chain as jax_guarded_chain
from grace_tpu.resilience import state_digest as jax_state_digest
from grace_tpu.train import init_train_state as jax_init_train_state
from grace_tpu.train import make_train_step as jax_make_train_step

from grace_tpu_torch import grace_from_params
from grace_tpu_torch.checkpoint import Checkpointer
from grace_tpu_torch.resilience import (ConsensusConfig, RetuneController,
                                        guarded_chain, replica_variants,
                                        state_digest)
from grace_tpu_torch.train import (TrainState, init_train_state,
                                   make_train_step)

pytestmark = pytest.mark.retune

TIMEOUT_S = 240
LR = 0.05


def _params(consensus_cls):
    """JAX's OLD_PARAMS and NEW_PARAMS (tests/test_retune.py:315-321) with
    the package's ConsensusConfig."""
    old = {"compressor": "homoqsgd", "quantum_num": 7,
           "memory": "residual", "communicator": "allreduce",
           "fusion": "flat", "escape": "fp16", "telemetry": 16,
           "consensus": consensus_cls(audit_every=10)}
    new = {"compressor": "powersgd", "compress_rank": 4,
           "memory": "powersgd", "communicator": "allreduce",
           "escape": "fp16", "telemetry": 16,
           "consensus": consensus_cls(audit_every=10),
           "adapt": {"window": 5, "ladder": [{"compress_rank": 1}]}}
    return old, new


OLD_PARAMS, NEW_PARAMS = _params(ConsensusConfig)
JAX_OLD, JAX_NEW = _params(JaxConsensusConfig)
GUARD = {"fallback_after": 3, "fallback_steps": 4}


# -- the host-side controller ----------------------------------------------------

def _pair(**kw):
    kw.setdefault("build", lambda p: (None, None))
    kw.setdefault("params", {"compressor": "homoqsgd"})
    return JaxRetuneController(**kw), RetuneController(**kw)


def test_observe_matches_jax_on_a_seeded_stream():
    """Windows of a seeded stream, healthy then hot then healthy, with
    None rows between: every return value and every event equal JAX's."""
    rng = np.random.default_rng(0)
    scale = np.repeat([1.0, 1.0, 3.5, 1.0, 3.5, 3.5, 3.5, 1.0, 4.0, 4.0],
                      6)
    stream = [None if i % 11 == 5 else float(v)
              for i, v in enumerate(scale * rng.uniform(0.8, 1.2,
                                                        scale.size))]
    j, p = _pair(window=4, drift_factor=2.0, drift_windows=2)
    assert [p.observe(i, v) for i, v in enumerate(stream)] == \
        [j.observe(i, v) for i, v in enumerate(stream)]
    assert p.events == j.events
    assert sum(e["event"] == "retune_drift" for e in p.events) >= 2


def test_watch_matches_jax_on_a_record_stream():
    """Metric rows, benign events, a trigger, then a quiet horizon: the
    returns and the clearing event equal JAX's."""
    stream = [[{"step": 3, "grad_norm": 1.0}, {"event": "watch", "step": 3}],
              [{"event": "guard_rearmed", "step": 4}],
              [{"event": "guard_skip", "step": 5}],
              [{"event": "consensus_escalation_rank", "step": 6}],
              [], [], []]
    j, p = _pair(probation_steps=9, demote_on=("guard_skip",
                                               "consensus_escalation"))
    outs = []
    for ctl in (j, p):
        ctl.phase, ctl._probation_until = "probation", 9
        outs.append([(ctl.watch(i + 3, recs), ctl.phase)
                     for i, recs in enumerate(stream)])
    assert outs[1] == outs[0]
    assert outs[1][2][0] == "guard_skip" and outs[1][-1][1] == "idle"
    assert p.events == j.events == [{"event": "retune_probation_clear",
                                     "step": 9, "config": "homoqsgd"}]


@pytest.mark.parametrize("knob,match", [
    ({"drift_factor": 1.0}, "drift_factor"), ({"window": 0}, "window"),
    ({"leg_timeout_s": 0.0}, "leg_timeout_s"),
    ({"leg_retries": -1}, "leg_retries")])
def test_knob_validation_matches_jax(knob, match):
    kw = {"build": lambda p: (None, None), "params": {}, **knob}
    with pytest.raises(ValueError, match=match) as jax_err:
        JaxRetuneController(**kw)
    with pytest.raises(ValueError, match=match) as port_err:
        RetuneController(**kw)
    assert str(port_err.value) == str(jax_err.value)


def test_watchdog_bounded_with_doubled_timeouts_like_jax():
    """A hung leg: two stalls recorded with JAX's payloads (the second at
    twice the first wait), the leg abandoned; a healthy leg passes."""
    events = []
    for ctl in _pair(leg_timeout_s=0.05, leg_retries=1):
        t0 = time.perf_counter()
        assert ctl._watchdog("drill", 7, lambda: time.sleep(30)) == \
            (False, None, 2)
        assert time.perf_counter() - t0 < 5.0
        assert ctl._watchdog("drill", 8, lambda: "done") == (True, "done", 0)
        events.append(ctl.events)
    assert events[1] == events[0]
    assert [e["timeout_s"] for e in events[1]] == [0.05, 0.1]


def test_watchdog_exceptions_propagate_unretried():
    for ctl in _pair(leg_timeout_s=5.0, leg_retries=3):
        calls = []

        def boom():
            calls.append(1)
            raise RuntimeError("leg failed")

        with pytest.raises(RuntimeError, match="leg failed"):
            ctl._watchdog("drill", 0, boom)
        assert len(calls) == 1 and ctl.events == []


def test_state_digest_equals_jax_and_is_content_sensitive():
    """Float, integer, bool and scalar leaves in one order: the port's
    digest of the tensors equals JAX's of the numpy arrays (exactly)."""
    rng = np.random.default_rng(3)
    arrays = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.integers(-9, 9, (7,)).astype(np.int32),
              "c": np.asarray(rng.random((2, 2)) > 0.5),
              "d": np.float32(2.5), "e": np.arange(4, dtype=np.uint8)}
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
    assert state_digest(tensors) == jax_state_digest(arrays)
    tensors["a"][1, 2] += 1.0
    assert state_digest(tensors) != jax_state_digest(arrays)


# -- the transaction at W=1 ------------------------------------------------------

class MLP(nn.Module):
    """JAX's toy MLP (tests/test_retune.py:98-112), its leaves named alike."""

    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, nn.Parameter(torch.tensor(np.asarray(v))))

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


def _mlp_params(rng):
    return {"w1": rng.normal(scale=0.3, size=(32, 16)).astype(np.float32),
            "b1": np.zeros((16,), np.float32),
            "w2": rng.normal(scale=0.3, size=(16, 8)).astype(np.float32),
            "b2": np.zeros((8,), np.float32)}


def _loss(model, batch):
    return nn.functional.cross_entropy(model(batch[0]), batch[1])


def _batches(seed, n, size=16):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.normal(size=(size, 32)).astype(
        np.float32)), torch.from_numpy(rng.integers(0, 8, size)))
        for _ in range(n)]


def _builder(group, unguarded=False):
    def build(p):
        grc = grace_from_params(p, group=group)
        if unguarded:
            return grc, grc.transform(seed=0)
        return grc, guarded_chain(grc, seed=0, **GUARD)
    return build


@pytest.fixture(scope="module")
def group():
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu")
    yield g
    torch.distributed.destroy_process_group()


def _warm(group, steps=4, optimizer=None):
    """JAX's _warm in the port: the incumbent after ``steps`` steps
    (``optimizer(params)``: plain SGD unless given)."""
    model = MLP(_mlp_params(np.random.default_rng(0)))
    _, tx = _builder(group)(OLD_PARAMS)
    make = optimizer or (lambda ps: torch.optim.SGD(ps, lr=LR))
    state = init_train_state(model, tx, make(model.parameters()), group)
    step = make_train_step(_loss, tx, group,
                           consensus=OLD_PARAMS["consensus"])
    for b in _batches(1, steps):
        state, _ = step(state, b)
    return state


@pytest.fixture(scope="module")
def ctl(group, tmp_path_factory):
    """One controller for the W=1 transactions, as a run keeps one. Each
    test leaves it idle (or prepared, which a prepare replaces)."""
    ckpt = tmp_path_factory.mktemp("retune") / "ckpt"
    return RetuneController(
        build=_builder(group), params=OLD_PARAMS,
        consensus=OLD_PARAMS["consensus"], group=group, window=4,
        probation_steps=8, leg_timeout_s=120.0,
        checkpointer=Checkpointer(str(ckpt), max_to_keep=2))


def _jax_incumbent():
    """JAX's incumbent on a one-device mesh after four steps, and its
    PREPARE's migration counts (no checkpointer: the counts alone)."""
    mesh = Mesh(np.asarray(jax.devices()[:1]), (DEFAULT_AXIS,))

    def build(p):
        grc = jax_grace_from_params(p)
        return grc, jax_guarded_chain(grc, optax.sgd(LR), **GUARD)

    grc, tx = build(JAX_OLD)
    params = {k: jnp.asarray(v)
              for k, v in _mlp_params(np.random.default_rng(0)).items()}
    state = jax_init_train_state(params, tx, mesh)
    step = jax_make_train_step(
        lambda p, b: optax.softmax_cross_entropy_with_integer_labels(
            jnp.tanh(b[0] @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"],
            b[1]).mean(), tx, mesh, donate=False)
    for x, y in _batches(1, 4):
        state, _ = step(state, (jnp.asarray(x.numpy()),
                                jnp.asarray(y.numpy().astype(np.int32))))
    ctl = JaxRetuneController(build=build, params=JAX_OLD,
                              consensus=JAX_OLD["consensus"], audit_world=8)
    staged = ctl.prepare(4, state, mesh, JAX_NEW)
    assert staged is not None, ctl.events
    return state, staged.migration


def test_prepare_writes_nothing_and_migrates_as_jax(ctl):
    """PREPARE on the JAX incumbent carried into the port: the live
    state's digest is unchanged, nothing of the staged state aliases it,
    and the migration counts equal JAX's (exactly)."""
    from grace_tpu_torch.convert import grace_state_from_jax

    jstate, jax_mig = _jax_incumbent()

    def is_guard(n):
        return hasattr(n, "notfinite_count")

    guards = [n for n in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=is_guard) if is_guard(n)]
    model = MLP(jax.device_get(jstate.params))
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=LR),
                       grace_state_from_jax(jax.device_get(guards[0]),
                                            seed=0, rank=0))
    pre = state_digest(state)
    staged = ctl.prepare(4, state, NEW_PARAMS)
    assert staged is not None, ctl.events
    assert state_digest(state) == pre == staged.lkg_digest
    assert staged.migration == jax_mig
    assert staged.footprint_matches and staged.checkpointed
    assert staged.state.optimizer is not state.optimizer
    live = {t.data_ptr() for t in
            [*state.grace.inner.mem, *state.grace.inner.comp]
            if isinstance(t, torch.Tensor)}
    assert not live & {t.data_ptr() for t in staged.state.grace.inner.mem
                       if isinstance(t, torch.Tensor)}
    assert ctl.phase == "prepared" and ctl.leg_seconds["lint"] >= 0.0


def test_promote_then_quiet_probation_clears(group, ctl):
    state = _warm(group)
    n0 = len(ctl.events)
    assert ctl.prepare(4, state, NEW_PARAMS) is not None
    state, (_, tx2), ev = ctl.commit(4)
    assert ev["event"] == "retune_promote" and ev["old"] == "homoqsgd" \
        and ev["new"] == "powersgd" and ev["replica_variants"] == 1
    assert ctl.phase == "probation"
    step2 = make_train_step(_loss, tx2, group,
                            consensus=NEW_PARAMS["consensus"])
    for i, b in enumerate(_batches(2, ctl.probation_steps), start=5):
        state, loss = step2(state, b)
        assert ctl.watch(i, []) is None
    assert np.isfinite(float(loss))
    assert ctl.phase == "idle" and ctl.params["compressor"] == "powersgd"
    assert [e["event"] for e in ctl.events[n0:]] == [
        "retune_prepare", "retune_promote", "retune_probation_clear"]
    ctl.params = dict(OLD_PARAMS)        # the next test's incumbent


def test_guard_skip_demotes_bit_exactly_and_the_incumbent_trains(
        group, ctl):
    state = _warm(group)
    staged = ctl.prepare(4, state, NEW_PARAMS)
    state, (_, tx2), _ = ctl.commit(4)
    step2 = make_train_step(_loss, tx2, group,
                            consensus=NEW_PARAMS["consensus"])
    state, _ = step2(state, _batches(2, 1)[0])
    trig = ctl.watch(5, [{"event": "guard_skip", "step": 5}])
    assert trig == "guard_skip"
    restored, (_, tx3), dem = ctl.demote(5, state, trigger=trig)
    assert dem["restored"] is True and dem["bit_exact"] is True
    assert state_digest(restored) == staged.lkg_digest
    assert ctl.phase == "idle" and ctl.params["compressor"] == "homoqsgd"
    step3 = make_train_step(_loss, tx3, group,
                            consensus=OLD_PARAMS["consensus"])
    restored, loss = step3(restored, _batches(3, 1)[0])
    assert np.isfinite(float(loss))
    assert ctl.prepare(6, restored, NEW_PARAMS) is not None


def _opt_tensors(opt):
    return {(i, k): v for i, p in enumerate(
        p for g in opt.param_groups for p in g["params"])
        for k, v in opt.state[p].items() if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("optimizer", [
    pytest.param(lambda ps: torch.optim.SGD(ps, lr=LR, momentum=0.9),
                 id="sgd_momentum"),
    pytest.param(lambda ps: torch.optim.AdamW(ps, lr=1e-3), id="adamw"),
])
def test_optimizer_state_carried_unaliased_and_demoted_bit_exactly(
        group, ctl, optimizer):
    """PREPARE over an optimizer with per-parameter state (SGD's momentum,
    AdamW's moments and step): the staged optimizer is of the same class
    with the same settings over the same parameters, its state equal to
    the live one's and aliasing none of it; the incumbent's digest is
    unchanged, and a staged step leaves the live optimizer's state as it
    was. The demotion restores it bit for bit, and the incumbent trains.
    At step 50: the newest known-good checkpoint is this PREPARE's."""
    state = _warm(group, optimizer=optimizer)
    live = state.optimizer
    before = {k: v.clone() for k, v in _opt_tensors(live).items()}
    assert before
    pre = state_digest(state)
    staged = ctl.prepare(50, state, NEW_PARAMS)
    assert staged is not None, ctl.events[-1]
    assert state_digest(state) == pre == staged.lkg_digest
    opt = staged.state.optimizer
    assert type(opt) is type(live) and opt is not live
    assert opt.defaults == live.defaults
    assert [p for g in opt.param_groups for p in g["params"]] == \
        [p for g in live.param_groups for p in g["params"]]
    assert [{k: v for k, v in g.items() if k != "params"}
            for g in opt.param_groups] == \
        [{k: v for k, v in g.items() if k != "params"}
         for g in live.param_groups]
    carried = _opt_tensors(opt)
    assert carried.keys() == before.keys()
    for k, v in carried.items():
        assert torch.equal(v, before[k])
        assert v.data_ptr() != _opt_tensors(live)[k].data_ptr()

    state2, (_, tx2), _ = ctl.commit(50)
    step2 = make_train_step(_loss, tx2, group,
                            consensus=NEW_PARAMS["consensus"])
    state2, _ = step2(state2, _batches(2, 1)[0])
    for k, v in _opt_tensors(live).items():
        assert torch.equal(v, before[k]), k
    assert not all(torch.equal(v, before[k])
                   for k, v in _opt_tensors(state2.optimizer).items())
    trig = ctl.watch(51, [{"event": "guard_skip", "step": 51}])
    restored, (_, tx3), dem = ctl.demote(51, state2, trigger=trig)
    assert dem["restored"] is True and dem["bit_exact"] is True
    assert state_digest(restored) == pre
    assert type(restored.optimizer) is type(live)
    for k, v in _opt_tensors(restored.optimizer).items():
        assert torch.equal(v, before[k]), k
    step3 = make_train_step(_loss, tx3, group,
                            consensus=OLD_PARAMS["consensus"])
    restored, loss = step3(restored, _batches(3, 1)[0])
    assert np.isfinite(float(loss)) and ctl.phase == "idle"


def test_prepare_during_probation_raises(group, ctl):
    state = _warm(group, steps=1)
    assert ctl.prepare(1, state, NEW_PARAMS) is not None
    assert ctl.commit(1) is not None
    with pytest.raises(RuntimeError, match="probation"):
        ctl.prepare(2, state, NEW_PARAMS)
    assert ctl.watch(1 + ctl.probation_steps, []) is None
    assert ctl.phase == "idle"
    ctl.params = dict(OLD_PARAMS)


def test_chain_structure_mismatch_aborts_at_migrate(group, ctl):
    """A build whose chain differs from the live state's (unguarded
    against guarded) aborts at the migrate gate, after the lint gate."""
    state = _warm(group, steps=1)
    pre = state_digest(state)
    ctl.build = _builder(group, unguarded=True)
    try:
        assert ctl.prepare(1, state, NEW_PARAMS) is None
    finally:
        ctl.build = _builder(group)
    assert ctl.phase == "idle" and state_digest(state) == pre
    ev = ctl.events[-1]
    assert ev["event"] == "retune_abort" and ev["leg"] == "migrate"


def test_auditor_rejected_candidate_aborts_at_lint(group):
    """fp16 summed over 512 ranks overflows (numeric_safety): the lint
    child, run beside this process's default group, rejects it."""
    assert torch.distributed.is_initialized()
    state = _warm(group, steps=1)
    ctl = RetuneController(build=_builder(group), params=OLD_PARAMS,
                           group=group, audit_world=512)
    bad = {"compressor": "fp16", "memory": "none",
           "communicator": "allreduce"}
    assert ctl.prepare(1, state, bad) is None
    ev = ctl.events[-1]
    assert ev["event"] == "retune_abort" and ev["leg"] == "lint"
    assert ev["lint_errors"] >= 1 and "float16 accumulation" in ev["reason"]
    assert ctl.phase == "idle"


# -- two ranks: promote, sabotage, demote ----------------------------------------

def _two_rank_worker(rank, init_file, ckpt_dir, out):
    import dataclasses

    from grace_tpu_torch.parallel import init_process_group
    from grace_tpu_torch.resilience import ChaosCompressor
    from grace_tpu_torch.utils.logging import GuardMonitor
    from grace_tpu_torch.utils.metrics import guard_report

    group, _ = init_process_group("cpu", rank=rank, world_size=2,
                                  init_method=f"file://{init_file}")
    torch.set_num_threads(1)
    try:
        chaos = {"nan": False}

        def build(p):
            grc = grace_from_params(p, group=group)
            if chaos["nan"]:
                grc = dataclasses.replace(grc, compressor=ChaosCompressor(
                    inner=grc.compressor, nan_prob=1.0, rank=0, seed=5,
                    group=group))
            return grc, guarded_chain(grc, seed=0, **GUARD)

        model = MLP(_mlp_params(np.random.default_rng(0)))
        _, tx = build(OLD_PARAMS)
        state = init_train_state(model, tx, torch.optim.SGD(
            model.parameters(), lr=LR), group)
        step = make_train_step(_loss, tx, group,
                               consensus=OLD_PARAMS["consensus"])
        for b in _batches(10 + rank, 3):
            state, _ = step(state, b)
        ctl = RetuneController(
            build=build, params=OLD_PARAMS,
            consensus=OLD_PARAMS["consensus"], group=group,
            checkpointer=Checkpointer(ckpt_dir, max_to_keep=2),
            probation_steps=8, leg_timeout_s=120.0)
        chaos["nan"] = True
        assert ctl.prepare(3, state, NEW_PARAMS) is not None
        chaos["nan"] = False
        state, (_, tx2), ev = ctl.commit(3)
        after_commit = replica_variants(state, group)
        tape = []

        class Tape:
            def write(self, rec):
                tape.append(dict(rec))

        monitor = GuardMonitor(printer=lambda *a: None, sink=Tape())
        monitor.update(3, guard_report(state))
        step2 = make_train_step(_loss, tx2, group,
                                consensus=NEW_PARAMS["consensus"])
        trig, i = None, 4
        for i, b in enumerate(_batches(20 + rank, 4), start=4):
            state, _ = step2(state, b)
            n0 = len(tape)
            monitor.update(i, guard_report(state))
            trig = ctl.watch(i, tape[n0:])
            if trig:
                break
        restored, (_, tx3), dem = ctl.demote(i, state, trigger=trig)
        step3 = make_train_step(_loss, tx3, group,
                                consensus=OLD_PARAMS["consensus"])
        restored, loss = step3(restored, _batches(30 + rank, 1)[0])
        torch.save({"trigger": trig, "trigger_step": i,
                    "probation_until": ev["probation_until"],
                    "barrier_variants": ev["replica_variants"],
                    "after_commit": after_commit,
                    "after_demote": replica_variants(restored, group),
                    "bit_exact": dem["bit_exact"],
                    "restored": dem["restored"],
                    "params": {k: v.detach().clone() for k, v in
                               restored.model.named_parameters()},
                    "loss": float(loss),
                    "events": [e["event"] for e in ctl.events]},
                   out.format(rank))
    finally:
        torch.distributed.destroy_process_group()


def test_two_ranks_promote_sabotage_demote(tmp_path):
    out = str(tmp_path / "rank{}.pt")
    ctx = mp.start_processes(
        _two_rank_worker, args=(str(tmp_path / "store"),
                                str(tmp_path / "ckpt"), out),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"two-rank retune did not finish in {TIMEOUT_S} s")
    res = [torch.load(out.format(r)) for r in range(2)]
    for r in res:
        assert r["trigger"] == "guard_skip"
        assert r["trigger_step"] < r["probation_until"]
        assert r["barrier_variants"] == r["after_commit"] == 1
        assert r["after_demote"] == 1
        assert r["restored"] and r["bit_exact"]
        assert np.isfinite(r["loss"])
        assert r["events"] == ["retune_prepare", "retune_promote",
                               "retune_demote"]
    for k, v in res[0]["params"].items():
        assert torch.equal(v, res[1]["params"][k])
