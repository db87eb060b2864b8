"""The port's adaptive compression ladder against the JAX package's, on the
CPU.

* The controller alone: ``normalize_adapt``'s spellings, the config's
  errors, and ``adapt_advance`` window by window against JAX's (tighten on
  a mean spike and on the peak alone, the hysteresis band, loosening after
  quiet windows, escalate-and-hold, the dense floor, a non-finite signal):
  every host field and both window statistics equal. A window mean at a
  threshold decides as jitted XLA does (the division by the window is a
  multiplication by its float32 reciprocal).
* At four gloo ranks against JAX's four-device mesh (Top-K chunk, a
  ladder of two ratios, window 3, one step forced into the fallback
  window; SGD at lr 0.25): the controller's host fields after every step
  (its window statistics within rtol 1e-5, the compression error's sum of
  squares running in another order), the parameters (bit for bit up to the first dense step, then atol 1e-6: the
  escape's float32 all-reduce sums in another order) and every rank's
  ring, ``adapt_rung``, ``adapt_bytes`` and the wire bytes exact; the
  trajectory visits every rung. The same at one rank against a one-device
  mesh.
* A quiet adaptive run equals the static top-rung run bit for bit, in the
  port and against JAX; a guard that skips every step leaves the
  controller at its init; the chaos lifecycle at four ranks (drift →
  tighten before any guard event → quiet → loosen → NaN → escalation);
  the two convergence floors of the JAX package at its batch.
* The build errors, a rung of another state structure, the helper's
  ``adapt`` key (override dicts, PowerSGD ladders padded to the largest
  rank, an AdaptConfig passed through), ``AdaptMonitor``, the checkpoint's
  ``adapt``, ``convert`` of a JAX ``AdaptState``, the consensus view, and
  ``migrate_grace_state`` (carried, overlap, fresh) against JAX's.
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

from grace_tpu import compressors as JC
from grace_tpu import grace_from_params as jax_grace_from_params
from grace_tpu.resilience.adapt import AdaptConfig as JaxAdaptConfig
from grace_tpu.resilience.adapt import AdaptMonitor as JaxAdaptMonitor
from grace_tpu.resilience.adapt import adapt_advance as jax_adapt_advance
from grace_tpu.resilience.adapt import adapt_init as jax_adapt_init
from grace_tpu.resilience.adapt import \
    adapt_signal_bytes as jax_adapt_signal_bytes
from grace_tpu.train import TrainState as JaxTrainState
from grace_tpu.train import _lazy_sharded_step, init_train_state
from grace_tpu.transform import add_world_axis, strip_world_axis
from grace_tpu.transform import set_fallback_flag as jax_set_fallback_flag

from grace_tpu_torch import compressors as C
from grace_tpu_torch import grace_from_params
from grace_tpu_torch.ops import chunk_topk
from grace_tpu_torch.resilience import (AdaptConfig, AdaptMonitor,
                                        AdaptState, adapt_report,
                                        guarded_chain, normalize_adapt)
from grace_tpu_torch.resilience.adapt import (adapt_advance, adapt_init,
                                              adapt_signal_bytes)
from grace_tpu_torch.telemetry.state import FIELD_INDEX
from grace_tpu_torch.transform import (GRACE_REPLICATED_FIELDS,
                                       grace_transform, set_fallback_flag)

WORLD = 4
TIMEOUT_S = 240
LR = 0.25
SHAPES = {"h1": (12, 12), "b1": (12,), "w": (12, 3), "b": (3,)}
# Top-K chunk, rel. error ~0.95 at 5% and ~0.8 at 30% on these gradients:
# 2 → 1 → 0 in two windows, two quiet windows on the dense rung, back to 1.
LIVE = {"compressor": "topk", "compress_ratio": 0.05,
        "topk_algorithm": "chunk", "memory": "residual",
        "communicator": "allgather", "escape": "none", "telemetry": 64,
        "adapt": {"window": 3, "ladder": [{"compress_ratio": 0.3}],
                  "tighten_error": 0.5, "tighten_peak": 0.75,
                  "loosen_error": 0.25, "quiet_windows": 2,
                  "hold_windows": 2}}
LIVE_STEPS = 16
LIVE_FALLBACK = (14,)          # steps forced into the fallback window
QUIET = {**LIVE, "adapt": {**LIVE["adapt"], "tighten_error": 50.0,
                           "tighten_peak": 75.0, "loosen_error": 25.0}}
STATIC = {k: v for k, v in LIVE.items() if k != "adapt"}
QUIET_STEPS = 6
HOST = ("rung", "fb_steps", "quiet", "hold", "tightens", "loosens",
        "escalations", "last_change_step")


def make_grads(world, steps, seed=0):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal((world, steps) + s) * 0.5).astype(
        np.float32) for n, s in SHAPES.items()}


def make_params(seed=1):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for n, s in SHAPES.items()}


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


# -- the runs ---------------------------------------------------------------------

def run_jax(cfg, grads, steps, world, flags=()):
    """JAX's transform + SGD on a ``world``-device submesh, fixed gradients:
    per step every device's parameters and the controller's fields; the
    rings at the end."""
    grc = jax_grace_from_params(cfg)
    tx = optax.chain(grc.transform(seed=1), optax.sgd(LR))
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    state = init_train_state({n: jnp.asarray(a)
                              for n, a in make_params().items()}, tx, mesh)

    def device_step(st, batch):
        g = jax.tree.map(lambda a: a[0], batch)
        opt = strip_world_axis(st.opt_state)
        updates, opt = tx.update(g, opt, st.params)
        return (JaxTrainState(optax.apply_updates(st.params, updates),
                              add_world_axis(opt)), jnp.zeros(()))

    step = _lazy_sharded_step(device_step, mesh, "data", donate=False)
    out = []
    for s in range(steps):
        state = state._replace(opt_state=jax_set_fallback_flag(
            state.opt_state, s in flags))
        state, _ = step(state, {n: jnp.asarray(a[:world, s])
                                for n, a in grads.items()})
        gs = state.opt_state[0]
        rec = {"params": {n: np.stack([np.asarray(sh.data) for sh in sorted(
            leaf.addressable_shards, key=lambda sh: sh.device.id)])
            for n, leaf in state.params.items()}}
        if gs.adapt is not None:
            rec["adapt"] = {k: np.asarray(v).reshape(-1)[0].item()
                            for k, v in gs.adapt._asdict().items()}
        out.append(rec)
    gs = state.opt_state[0]
    return out, np.asarray(gs.telem.rings), np.asarray(gs.telem.steps)


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


def _adapt_fields(a: AdaptState) -> dict:
    d = {k: getattr(a.settle(), k) for k in HOST}
    d["err_sum"] = float(a.err_sum)
    d["err_peak"] = float(a.err_peak)
    return d


def run_port(cfg, grads, steps, group, rank, flags=()):
    """The same run in the port, this rank's side: per step the parameters
    and the controller's fields (its boundary decision made); the ring and
    the state at the end."""
    tx = grace_from_params(cfg, group=group).transform(seed=1)
    ps = {n: torch.nn.Parameter(torch.from_numpy(a))
          for n, a in make_params().items()}
    opt = torch.optim.SGD(list(ps.values()), lr=LR)
    state = tx.init(ps)
    out = []
    for s in range(steps):
        state = set_fallback_flag(state, s in flags)
        updates, state = tx.update(
            {n: torch.from_numpy(a[rank, s].copy())
             for n, a in grads.items()}, state)
        for n, p in ps.items():
            p.grad = updates[n]
        opt.step()
        rec = {"params": {n: p.detach().numpy().copy()
                          for n, p in ps.items()}}
        if state.adapt is not None:
            rec["adapt"] = _adapt_fields(state.adapt)
        out.append(rec)
    return out, state.telem.rings.numpy().copy(), \
        state.telem.steps.numpy().copy(), state


def _assert_run_equal(got, want, rank, rungs):
    """``got`` (the port's records of one rank) against JAX's: controller
    fields exact; parameters bit for bit until the first dense step
    (``rungs``: each step's effective rung, 0 dense), then within 1e-6."""
    dense_from = rungs.index(0) if 0 in rungs else len(rungs)
    for s, (g, w) in enumerate(zip(got, want)):
        label = f"step {s} rank {rank}"
        if "adapt" in w:
            for k in HOST:
                assert g["adapt"][k] == w["adapt"][k], (label, k)
            for k in ("err_sum", "err_peak"):
                # The error's sum of squares runs in another order: the
                # telemetry tests' tolerance.
                np.testing.assert_allclose(g["adapt"][k], w["adapt"][k],
                                           rtol=1e-5, err_msg=f"{label} {k}")
        for n in SHAPES:
            if s < dense_from:
                np.testing.assert_array_equal(
                    _bits(g["params"][n]), _bits(w["params"][n][rank]),
                    err_msg=f"{label} {n}")
            else:
                np.testing.assert_allclose(
                    g["params"][n], w["params"][n][rank], rtol=0, atol=1e-6,
                    err_msg=f"{label} {n}")


def _records_npz(prefix, recs, out):
    for s, r in enumerate(recs):
        for n, a in r["params"].items():
            out[f"{prefix}/{s}/param/{n}"] = a
        if "adapt" in r:
            out[f"{prefix}/{s}/adapt"] = np.frombuffer(
                json.dumps(r["adapt"]).encode(), dtype=np.uint8)


def _records_from(port, prefix, steps):
    recs = []
    for s in range(steps):
        r = {"params": {n: port[f"{prefix}/{s}/param/{n}"] for n in SHAPES}}
        key = f"{prefix}/{s}/adapt"
        if key in port:
            r["adapt"] = json.loads(port[key].tobytes())
        recs.append(r)
    return recs


def _worker(rank, init_file, paths, out_paths):
    from grace_tpu_torch.parallel import init_process_group

    group, _ = init_process_group("cpu", rank=rank, world_size=WORLD,
                                  init_method=f"file://{init_file}")
    _inplace_spelling()
    torch.set_num_threads(1)
    try:
        out = {}
        with np.load(paths["live"]) as data:
            grads = {n: data[n] for n in data.files}
        recs, rings, steps, _ = run_port(LIVE, grads, LIVE_STEPS, group,
                                         rank, LIVE_FALLBACK)
        _records_npz("live", recs, out)
        out["live/rings"], out["live/steps"] = rings, steps
        with np.load(paths["quiet"]) as data:
            grads = {n: data[n] for n in data.files}
        for name, cfg in (("quiet", QUIET), ("static", STATIC)):
            recs, rings, steps, _ = run_port(cfg, grads, QUIET_STEPS, group,
                                             rank)
            _records_npz(name, recs, out)
            out[f"{name}/rings"] = rings
        out["rollback"] = np.frombuffer(json.dumps(
            _rollback_run(group)).encode(), dtype=np.uint8)
        out["lifecycle"] = np.frombuffer(json.dumps(
            _lifecycle_run(group, rank)).encode(), dtype=np.uint8)
        out["floors"] = np.array(_floors_run(group, rank))
        np.savez(out_paths[rank], **out)
    finally:
        torch.distributed.destroy_process_group()


# -- port-only scenarios at four ranks ------------------------------------------

def _ls_problem(rank, seed=0):
    """JAX's least-squares problem (``tests/test_adapt.py``), this rank's
    quarter of its batch of 64."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(20, 4)).astype(np.float32)
    x = rng.normal(size=(64, 20)).astype(np.float32)
    y = np.argmax(x @ w_true, axis=1).astype(np.int64)
    part = slice(rank * 16, (rank + 1) * 16)
    return torch.from_numpy(x[part]), torch.from_numpy(y[part])


def _train(cfg, group, params, loss_fn, batch, steps, lr, guard=None):
    from grace_tpu_torch.train import init_train_state, make_train_step

    model = torch.nn.ParameterDict(
        {n: torch.nn.Parameter(torch.from_numpy(a.copy()))
         for n, a in params.items()})
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    grc = grace_from_params(cfg, group=group) if isinstance(cfg, dict) \
        else cfg
    tx = grc.transform(seed=0) if guard is None else \
        guarded_chain(grc, **guard)
    state = init_train_state(model, tx, opt, group)
    step = make_train_step(loss_fn, tx, group)
    loss = None
    for _ in range(steps):
        state, loss = step(state, batch)
    return state, float(loss)


def _linear_loss(model, batch):
    x, y = batch
    return torch.nn.functional.cross_entropy(x @ model["w"], y)


ADAPTIVE_QSGD = {"compressor": "qsgd", "quantum_num": 15,
                 "use_pallas": False, "memory": "none",
                 "communicator": "allgather", "escape": "fp16",
                 "telemetry": 16,
                 "adapt": {"window": 4, "ladder": [{"quantum_num": 127}],
                           "tighten_error": 0.5, "tighten_peak": 0.75,
                           "loosen_error": 0.25, "quiet_windows": 2,
                           "hold_windows": 2}}


def _rollback_run(group) -> dict:
    """Every step poisoned on rank 0's payload: the guard skips all six,
    and the controller never advances."""
    from grace_tpu_torch.resilience import ChaosCommunicator
    from grace_tpu_torch.utils.metrics import guard_report

    grc = grace_from_params(ADAPTIVE_QSGD, group=group)
    grc = dataclasses.replace(grc, communicator=ChaosCommunicator(
        inner=grc.communicator, nan_prob=1.0, rank=0, seed=1))
    state, _ = _train(grc, group, {"w": np.zeros((20, 4), np.float32)},
                      _linear_loss, _ls_problem(group.rank()), 6, 0.05,
                      guard={})
    return {"adapt": adapt_report(state),
            "skips": guard_report(state)["notfinite_count"]}


LIFECYCLE_WINDOW = 4


def _lifecycle_run(group, rank) -> dict:
    """JAX's ``chaos_smoke --adapt`` lifecycle at four ranks: one rank's
    encoder drifts (ChaosCompressor around every rung) → tighten, no guard
    event; the drift off → loosen; NaN on the wire → the guard trips and
    the controller escalates. The events go through one sink, whose
    timeline orders the first adapt event before the first guard event."""
    from grace_tpu_torch.resilience import (ChaosCommunicator,
                                            ChaosCompressor)
    from grace_tpu_torch.resilience.smoke.common import wrap_codec
    from grace_tpu_torch.telemetry import TelemetryReader
    from grace_tpu_torch.telemetry.timeline import Timeline
    from grace_tpu_torch.train import init_train_state, make_train_step
    from grace_tpu_torch.utils.logging import GuardMonitor
    from grace_tpu_torch.utils.metrics import guard_report

    window = LIFECYCLE_WINDOW
    cfg = {**ADAPTIVE_QSGD, "adapt": {
        "window": window, "ladder": [{"quantum_num": 127}],
        "tighten_error": 0.5, "tighten_peak": 0.6, "loosen_error": 0.35,
        "quiet_windows": 2, "hold_windows": 2}}
    steps_a, steps_b, steps_c = 3 * window, 4 * window, window + 3 + 4 + 2

    def build(drift_rank=None, nan_prob=0.0):
        grc = grace_from_params(cfg, group=group)
        if drift_rank is not None:
            # The drill's own wrapper: the compressor and every rung.
            grc = wrap_codec(grc, lambda c: ChaosCompressor(
                inner=c, drift_scale=0.9, rank=drift_rank, seed=3,
                group=group))
        if nan_prob:
            grc = dataclasses.replace(grc, communicator=ChaosCommunicator(
                inner=grc.communicator, nan_prob=nan_prob, rank=0, seed=1))
        return guarded_chain(grc, fallback_after=3, fallback_steps=4)

    rng = np.random.default_rng(0)
    params = {"w1": rng.normal(scale=0.3, size=(32, 16)).astype(np.float32),
              "b1": np.zeros(16, np.float32),
              "w2": rng.normal(scale=0.3, size=(16, 8)).astype(np.float32),
              "b2": np.zeros(8, np.float32)}
    images = rng.normal(size=(64, 32)).astype(np.float32)
    labels = rng.integers(0, 8, size=64)

    def loss_fn(m, b):
        x, y = b
        h = torch.tanh(x @ m["w1"] + m["b1"])
        return torch.nn.functional.cross_entropy(h @ m["w2"] + m["b2"], y)

    def at(i):
        lo = (i * 16) % 48
        part = slice(lo + rank * 4, lo + rank * 4 + 4)
        return (torch.from_numpy(images[part]),
                torch.from_numpy(labels[part]))

    model = torch.nn.ParameterDict(
        {n: torch.nn.Parameter(torch.from_numpy(a)) for n, a in
         params.items()})
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    records = []

    class Sink:
        def write(self, rec):
            records.append(dict(rec))

    sink = Sink()
    reader = TelemetryReader(sink, every=window, group=group)
    adapt_mon = AdaptMonitor(sink=sink)
    guard_mon = GuardMonitor(printer=lambda *a, **k: None, sink=sink)
    state, total = None, float("nan")
    phases = ((build(drift_rank=3), 0, steps_a),
              (build(), steps_a, steps_a + steps_b),
              (build(nan_prob=1.0), steps_a + steps_b,
               steps_a + steps_b + steps_c))
    out = {}
    for pi, (tx, lo, hi) in enumerate(phases):
        if state is None:
            state = init_train_state(model, tx, opt, group)
        step = make_train_step(loss_fn, tx, group)
        for i in range(lo, hi):
            state, loss = step(state, at(i))
            guard_mon.update(i, guard_report(state))
            adapt_mon.observe(reader.update(i, state))
        adapt_mon.observe(reader.flush(state))
        out[f"phase{pi}"] = {"adapt": adapt_report(state),
                             "guard": guard_report(state)["notfinite_count"]}
        total = float(loss)
    tl = Timeline.from_records(records)
    first_adapt = next(e.step for e in tl.kinds("adapt")
                       if e.step is not None)
    first_guard = next(e.step for e in tl.kinds("guard")
                       if e.step is not None)
    tightens = [e["step"] for e in adapt_mon.events
                if e["event"] == "adapt_tighten"]
    out.update(first_adapt=first_adapt, first_guard=first_guard,
               first_tighten=min(tightens), final_loss=total)
    return out


def _floors_run(group, rank) -> list:
    """JAX's two convergence floors (``tests/test_adapt.py:717-795``) at
    its batch of 64, a quarter a rank: the routed transformer-shaped track
    against dense fp16, and the adaptive homoqsgd ladder against its
    static config."""
    rng = np.random.default_rng(11)
    w_true = rng.normal(size=(24, 6)).astype(np.float32)
    x = rng.normal(size=(64, 24)).astype(np.float32)
    y = np.argmax(x @ w_true, axis=1)
    params = {"emb": rng.normal(scale=0.3, size=(24, 16)).astype(np.float32),
              "ln_scale": np.ones(16, np.float32),
              "bias": np.zeros(16, np.float32),
              "head": rng.normal(scale=0.3, size=(16, 6)).astype(np.float32)}
    part = slice(rank * 16, (rank + 1) * 16)
    batch = (torch.from_numpy(x[part]), torch.from_numpy(y[part]))

    def routed_loss(m, b):
        xb, yb = b
        h = torch.tanh(xb @ m["emb"] * m["ln_scale"] + m["bias"])
        return torch.nn.functional.cross_entropy(h @ m["head"], yb)

    fp16 = {"compressor": "fp16", "memory": "none",
            "communicator": "allreduce"}
    _, dense = _train(fp16, group, params, routed_loss, batch, 60, 0.3)
    _, routed = _train({"compressor": "topk", "compress_ratio": 0.25,
                        "memory": "residual", "communicator": "rscatter",
                        "route": [("*ln*", fp16), ("*bias*", fp16)]},
                       group, params, routed_loss, batch, 60, 0.3)
    homo = {"compressor": "homoqsgd", "quantum_num": 7, "memory": "residual",
            "communicator": "ring", "fusion": "flat"}
    w0 = {"w": np.zeros((20, 4), np.float32)}
    batch = _ls_problem(rank, seed=3)
    _, static = _train(homo, group, w0, _linear_loss, batch, 60, 0.3)
    state, adaptive = _train(
        {**homo, "escape": "fp16", "telemetry": 16,
         "adapt": {"window": 10, "ladder": [{"quantum_num": 127}],
                   "tighten_error": 5.0, "tighten_peak": 7.5,
                   "loosen_error": 2.5}},
        group, w0, _linear_loss, batch, 60, 0.3)
    return [dense, routed, static, adaptive, adapt_report(state)["rung"]]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("adapt")
    grads = {"live": make_grads(WORLD, LIVE_STEPS, seed=5),
             "quiet": make_grads(WORLD, QUIET_STEPS, seed=6)}
    paths = {}
    for name, g in grads.items():
        paths[name] = str(tmp / f"{name}.npz")
        np.savez(paths[name], **g)
    outs = [tmp / f"rank{r}.npz" for r in range(WORLD)]
    ctx = mp.start_processes(
        _worker, args=(str(tmp / "store"), paths, [str(o) for o in outs]),
        nprocs=WORLD, join=False, start_method="spawn")
    ref = {"live": run_jax(LIVE, grads["live"], LIVE_STEPS, WORLD,
                           LIVE_FALLBACK),
           "static": run_jax(STATIC, grads["quiet"], QUIET_STEPS, WORLD)}
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
    return port, ref


# -- four ranks against JAX -----------------------------------------------------

def test_live_ladder_equals_jax_at_four_ranks(four_ranks):
    from test_torch_telemetry import assert_ring_equal

    port, ref = four_ranks
    want, jrings, jsteps = ref["live"]
    trajectory = [w["adapt"]["rung"] for w in want]
    rungs = jrings[0][:LIVE_STEPS, FIELD_INDEX["adapt_rung"]].astype(
        int).tolist()
    for r in range(WORLD):
        got = _records_from(port[r], "live", LIVE_STEPS)
        _assert_run_equal(got, want, r, rungs)
        assert_ring_equal(port[r]["live/rings"], port[r]["live/steps"],
                          jrings[r], jsteps[r], world=WORLD)
    rung_col = jrings[0][:LIVE_STEPS, FIELD_INDEX["adapt_rung"]]
    assert set(rung_col.tolist()) == {0.0, 1.0, 2.0}
    assert len(set(trajectory)) == 3
    # The rows the fallback forced read rung 0 and the escape's price.
    for s in LIVE_FALLBACK:
        assert rung_col[s] == 0.0
        assert jrings[0][s, FIELD_INDEX["fallback"]] == 1.0


def test_live_ladder_prices_each_row_at_its_rung(four_ranks):
    """Every row's wire bytes are the active rung's plan plus the signal's
    ``adapt_bytes``, split by link; the plans are the port's own."""
    from grace_tpu_torch.comm import Allgather, Allreduce
    from grace_tpu_torch.utils.metrics import payload_nbytes

    port, _ = four_ranks
    rings = port[0]["live/rings"]
    structs = [(s, torch.float32) for s in SHAPES.values()]
    n = sum(int(np.prod(s)) for s in SHAPES.values())
    plans = {0: Allreduce().recv_wire_bytes(
        sum(payload_nbytes(C.NoneCompressor(), s) for s in structs), n,
        WORLD)}
    for rung, ratio in ((1, 0.3), (2, 0.05)):
        codec = C.TopKCompressor(compress_ratio=ratio, algorithm="chunk")
        plans[rung] = Allgather().recv_wire_bytes(
            sum(payload_nbytes(codec, s) for s in structs), n, WORLD)
    sig = adapt_signal_bytes(WORLD)
    assert sig == jax_adapt_signal_bytes(WORLD) == 12
    for row in rings[:LIVE_STEPS]:
        rung = int(row[FIELD_INDEX["adapt_rung"]])
        assert row[FIELD_INDEX["adapt_bytes"]] == sig
        assert row[FIELD_INDEX["wire_bytes"]] == np.float32(plans[rung] + sig)
        assert row[FIELD_INDEX["wire_bytes_ici"]] \
            + row[FIELD_INDEX["wire_bytes_dcn"]] \
            == row[FIELD_INDEX["wire_bytes"]]


def test_quiet_ladder_is_the_static_top_rung_bit_for_bit(four_ranks):
    port, ref = four_ranks
    want, jrings, _ = ref["static"]
    for r in range(WORLD):
        quiet = _records_from(port[r], "quiet", QUIET_STEPS)
        static = _records_from(port[r], "static", QUIET_STEPS)
        for s in range(QUIET_STEPS):
            assert quiet[s]["adapt"]["rung"] == 2
            for n in SHAPES:
                np.testing.assert_array_equal(
                    _bits(quiet[s]["params"][n]), _bits(static[s]["params"][n]))
                np.testing.assert_array_equal(
                    _bits(static[s]["params"][n]),
                    _bits(want[s]["params"][n][r]))
        np.testing.assert_array_equal(
            port[r]["quiet/rings"][:, FIELD_INDEX["compression_error"]],
            port[r]["static/rings"][:, FIELD_INDEX["compression_error"]])


def test_guard_rollback_keeps_the_controller_at_init(four_ranks):
    port, _ = four_ranks
    for r in range(WORLD):
        got = json.loads(port[r]["rollback"].tobytes())
        assert got == {"adapt": {"rung": 2, "tightens": 0, "loosens": 0,
                                 "escalations": 0, "hold": 0, "quiet": 0,
                                 "last_change_step": -1}, "skips": 6}


def test_chaos_adapt_lifecycle_at_four_ranks(four_ranks):
    """Drift → tighten within one window (plus the decision's latency)
    with the guard silent; quiet → loosen; NaN → the guard trips and the
    controller escalates; the first adapt event precedes the first guard
    event in the sink's timeline; the final loss is finite. The same on
    every rank."""
    port, _ = four_ranks
    docs = [json.loads(port[r]["lifecycle"].tobytes()) for r in range(WORLD)]
    assert all(d == docs[0] for d in docs)
    d = docs[0]
    assert d["phase0"]["guard"] == 0 and d["phase0"]["adapt"]["tightens"] >= 1
    assert d["first_tighten"] <= 2 * LIFECYCLE_WINDOW
    assert d["phase1"]["adapt"]["loosens"] >= 1
    assert d["phase2"]["guard"] >= 1 and d["phase2"]["adapt"]["escalations"] >= 1
    assert d["first_adapt"] < d["first_guard"]
    assert np.isfinite(d["final_loss"])


def test_convergence_floors_at_jax_batch(four_ranks):
    port, _ = four_ranks
    for r in range(WORLD):
        dense, routed, static, adaptive, rung = port[r]["floors"].tolist()
        assert dense < 1.0, dense
        assert routed < dense + 0.1, (routed, dense)
        assert static < 0.8, static
        assert adaptive < static + 0.05, (adaptive, static)
        assert rung == 2


# -- one rank against a one-device mesh ------------------------------------------

@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


def test_live_ladder_equals_jax_at_one_rank(group):
    from test_torch_telemetry import assert_ring_equal

    grads = make_grads(1, LIVE_STEPS, seed=7)
    want, jrings, jsteps = run_jax(LIVE, grads, LIVE_STEPS, 1, LIVE_FALLBACK)
    got, rings, steps, state = run_port(LIVE, grads, LIVE_STEPS, group, 0,
                                        LIVE_FALLBACK)
    _assert_run_equal(got, want, 0, jrings[0][:LIVE_STEPS, FIELD_INDEX[
        "adapt_rung"]].astype(int).tolist())
    assert_ring_equal(rings, steps, jrings[0], jsteps[0])
    assert {w["adapt"]["rung"] for w in want} == {0, 1, 2}
    assert rings[0, FIELD_INDEX["adapt_bytes"]] == 0.0     # no collective


# -- the controller alone ---------------------------------------------------------

def _cfgs(**kw):
    base = dict(window=4, tighten_error=0.5, tighten_peak=0.75,
                loosen_error=0.25, quiet_windows=2, hold_windows=3)
    base.update(kw)
    port = AdaptConfig(ladder=(C.QSGDCompressor(quantum_num=127),
                               C.QSGDCompressor(quantum_num=15)), **base)
    jax_cfg = JaxAdaptConfig(ladder=(JC.QSGDCompressor(quantum_num=127,
                                                       use_pallas=False),
                                     JC.QSGDCompressor(quantum_num=15,
                                                       use_pallas=False)),
                             **base)
    return port, jax_cfg


# name -> (windows of (err_mean, err_peak, fallback), initial rung or None)
SEQUENCES = {
    "mean_spike": ([(0.9, 0.9, False)], None),
    "peak_alone": ([(0.1, 0.9, False)], None),
    "hysteresis_band": ([(0.4, 0.4, False)] * 4, None),
    "loosen_after_quiet": ([(0.0, 0.0, False)] * 2 + [(0.9, 0.9, False)]
                           + [(0.0, 0.0, False)], 0),
    "escalate_and_hold": ([(0.0, 0.0, True)] + [(0.0, 0.0, False)] * 4,
                          None),
    "dense_floor": ([(0.9, 0.9, False)] * 5, None),
    "nonfinite_signal": ([(float("nan"), float("inf"), False),
                          (float("-inf"), float("nan"), False)], None),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_controller_equals_jax_window_by_window(name):
    windows, start = SEQUENCES[name]
    cfg, jcfg = _cfgs() if start is None else _cfgs(start_rung=start)
    a, ja = adapt_init(cfg), jax_adapt_init(jcfg)
    count = 0
    for mean, peak, fb in windows:
        for _ in range(cfg.window):
            a = adapt_advance(a, cfg, count, fb,
                              torch.tensor(mean, dtype=torch.float32),
                              torch.tensor(peak, dtype=torch.float32))
            ja = jax_adapt_advance(ja, jcfg, jnp.asarray(count, jnp.int32),
                                   jnp.asarray(fb),
                                   jnp.asarray(mean, jnp.float32),
                                   jnp.asarray(peak, jnp.float32))
            count += 1
        got = _adapt_fields(a)
        want = {k: np.asarray(v).item() for k, v in ja._asdict().items()}
        assert got == want, (name, got, want)
        assert np.isfinite(got["err_sum"])


def test_controller_semantics():
    """The JAX tests' facts on the port's controller: a spike tightens
    within one window, the band holds, loosening needs two quiet windows,
    a guard trip escalates and holds, the floor is dense."""
    cfg, _ = _cfgs()

    def window(a, mean, peak, fb=False, start=0):
        for i in range(cfg.window):
            a = adapt_advance(a, cfg, start + i, fb,
                              torch.tensor(mean), torch.tensor(peak))
        return a.settle()

    a = window(adapt_init(cfg), 0.9, 0.9)
    assert (a.rung, a.tightens, float(a.err_sum)) == (1, 1, 0.0)
    a = window(adapt_init(cfg), 0.0, 0.0, fb=True)
    assert (a.rung, a.escalations, a.hold) == (1, 1, cfg.hold_windows)
    for w in range(cfg.hold_windows):
        a = window(a, 0.0, 0.0, start=(w + 1) * cfg.window)
        assert a.rung == 1
    a = window(a, 0.0, 0.0, start=(cfg.hold_windows + 1) * cfg.window)
    assert (a.rung, a.loosens) == (2, 1)


def test_window_mean_decides_in_float32_as_jitted_xla():
    """A window sum whose mean sits on the threshold: ``sum · (1/5)`` and
    ``sum / 5`` fall on either side of 0.45 in float32, and the port takes
    jitted XLA's side (the reciprocal multiply)."""
    from grace_tpu.resilience.adapt import AdaptState as JaxAdaptState

    cfg, jcfg = _cfgs(window=5, tighten_error=0.45)
    inv, t = np.float32(1) / np.float32(5), np.float32(0.45)
    x = np.float32(2.24)
    for _ in range(1 << 16):
        if (x * inv > t) != (x / np.float32(5) > t):
            break
        x = np.nextafter(x, np.float32(3), dtype=np.float32)
    assert (x * inv > t) != (x / np.float32(5) > t)
    jstep = jax.jit(lambda s, c: jax_adapt_advance(
        s, jcfg, c, jnp.asarray(False), jnp.zeros((), jnp.float32),
        jnp.zeros((), jnp.float32)))
    ja = jax_adapt_init(jcfg)._replace(err_sum=jnp.asarray(x))
    ja = jstep(ja, jnp.asarray(4, jnp.int32))
    a = adapt_init(cfg)
    a.err_sum = torch.tensor(x)
    a = adapt_advance(a, cfg, 4, False, torch.zeros(()), torch.zeros(()))
    assert a.settle().rung == int(ja.rung)
    assert isinstance(ja, JaxAdaptState)


def test_normalize_adapt_spellings():
    base = C.QSGDCompressor(quantum_num=15)
    for spec in (True, 7, {"window": 7}):
        cfg = normalize_adapt(spec, base)
        assert cfg.ladder[-1] == base and cfg.n_rungs == 2
    cfg = normalize_adapt(7, base)
    assert cfg.window == 7
    assert normalize_adapt(cfg, base).ladder == cfg.ladder
    gentle = C.QSGDCompressor(quantum_num=127)
    cfg = normalize_adapt({"ladder": [gentle]}, base)
    assert cfg.ladder == (gentle, base) and cfg.top_rung == 2
    assert normalize_adapt(None, base) is None
    assert normalize_adapt(False, base) is None
    with pytest.raises(TypeError):
        normalize_adapt("yes", base)


@pytest.mark.parametrize("kw,match", [
    ({"window": 0}, "window"),
    ({"tighten_error": 0.3, "loosen_error": 0.3}, "hysteresis"),
    ({"tighten_peak": 0.1}, "tighten_peak"),
    ({"quiet_windows": 0}, "quiet_windows"),
    ({"hold_windows": -1}, "hold_windows"),
])
def test_adapt_config_validation(kw, match):
    base = dict(tighten_error=0.5, tighten_peak=0.75, loosen_error=0.25)
    base.update(kw)
    with pytest.raises(ValueError, match=match):
        AdaptConfig(**base)
    with pytest.raises(ValueError, match=match):
        JaxAdaptConfig(**base)


def test_start_rung_out_of_range_raises():
    with pytest.raises(ValueError, match="start_rung"):
        normalize_adapt(AdaptConfig(start_rung=9),
                        C.QSGDCompressor(quantum_num=15))


def test_adapt_signal_bytes_equal_jax():
    for w in range(1, 9):
        assert adapt_signal_bytes(w) == jax_adapt_signal_bytes(w)


def test_adapt_build_requirements():
    from grace_tpu_torch.comm import Allgather
    from grace_tpu_torch.memories import NoneMemory

    comp = C.QSGDCompressor(quantum_num=15)
    kw = dict(compressor=comp, memory=NoneMemory(), communicator=Allgather())
    with pytest.raises(ValueError, match="escape"):
        grace_transform(**kw, adapt=True, telemetry=True)
    with pytest.raises(ValueError, match="compression_error"):
        grace_transform(**kw, adapt=True, escape=C.FP16Compressor(),
                        telemetry={"compression_error": False})
    with pytest.raises(ValueError, match="telemetry"):
        grace_transform(**kw, adapt=True, escape=C.FP16Compressor())
    with pytest.raises(ValueError, match="routes"):
        grace_transform(**kw, adapt=True, escape=C.FP16Compressor(),
                        telemetry=True, topology=None,
                        routes=[("x", (comp, NoneMemory(), Allgather()))])


def test_mismatched_rung_state_structure_raises(group):
    grc = grace_from_params({
        "compressor": "topk", "compress_ratio": 0.1, "memory": "residual",
        "communicator": "allgather", "escape": "fp16", "telemetry": True},
        group=group)
    bad = AdaptConfig(ladder=(C.PowerSGDCompressor(rank=2, group=group),
                              grc.compressor), window=4)
    tx = dataclasses.replace(grc, adapt=bad).transform(seed=0)
    with pytest.raises(ValueError, match="identical mem/comp state"):
        tx.init({"w": torch.zeros(20, 4)})


def test_helper_builds_jax_ladders(group):
    params = {"compressor": "topk", "compress_ratio": 0.01,
              "topk_algorithm": "chunk", "memory": "residual",
              "communicator": "allgather", "fusion": "none",
              "escape": "fp16", "telemetry": True,
              "adapt": {"window": 5, "ladder": [{"compress_ratio": 0.04}]}}
    grc, jgrc = grace_from_params(params, group=group), \
        jax_grace_from_params(params)
    assert grc.adapt.window == jgrc.adapt.window == 5
    assert [c.compress_ratio for c in grc.adapt.ladder] == \
        [c.compress_ratio for c in jgrc.adapt.ladder] == [0.04, 0.01]
    assert grc.adapt.ladder[-1] is grc.compressor
    assert grc.adapt.ladder[0].algorithm == "chunk"
    for spec in (True, 6):
        assert grace_from_params({**params, "adapt": spec},
                                 group=group).adapt.n_rungs == 2
    cfg = AdaptConfig(ladder=(C.TopKCompressor(compress_ratio=0.2),),
                      window=3)
    passed = grace_from_params({**params, "adapt": cfg}, group=group)
    assert passed.adapt.window == 3 and passed.adapt.n_rungs == 3
    with pytest.raises(TypeError, match="adapt must be"):
        grace_from_params({**params, "adapt": "yes"}, group=group)
    # fsdp_axis is ported: on a 1×1 mesh over the group the ladder's
    # rungs and the communicator run on its dp group
    from grace_tpu_torch.parallel import make_mesh
    mesh = make_mesh((1, 1), ("data", "fsdp"), group=group)
    two_d = grace_from_params({**params, "fsdp_axis": "fsdp"}, group=mesh)
    assert two_d.mesh is mesh and two_d.adapt.n_rungs == grc.adapt.n_rungs
    assert two_d.communicator.group is mesh.dp_group
    with pytest.raises(ValueError, match="fsdp_axes"):
        grace_from_params({**params, "fsdp_axes": "fsdp"}, group=group)


def test_powersgd_ladder_states_padded_to_max_rank(group):
    params = {"compressor": "powersgd", "compress_rank": 2,
              "memory": "powersgd", "communicator": "allreduce",
              "escape": "fp16", "telemetry": 16,
              "adapt": {"window": 5, "ladder": [{"compress_rank": 4}]}}
    grc = grace_from_params(params, group=group)
    jgrc = jax_grace_from_params(params)
    assert [c.state_rank for c in grc.adapt.ladder] == \
        [c.state_rank for c in jgrc.adapt.ladder] == [4, 4]
    tx = grc.transform(seed=0)
    rng = np.random.default_rng(0)
    ps = {"w1": torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)),
          "w2": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
          "b": torch.zeros(8)}
    state = tx.init(ps)
    assert {q.shape[-1] for q in state.comp if q is not None} == {4}
    for s in range(3):
        grads = {n: torch.from_numpy(rng.normal(size=tuple(p.shape))
                                     .astype(np.float32))
                 for n, p in ps.items()}
        ups, state = tx.update(grads, state)
        assert all(torch.isfinite(u).all() for u in ups.values())


def test_adapt_is_replicated_and_fingerprinted(group):
    from grace_tpu_torch.resilience import fingerprint_tree, replicated_view

    assert "adapt" in GRACE_REPLICATED_FIELDS
    tx = grace_from_params({**STATIC, "adapt": LIVE["adapt"]},
                           group=group).transform(seed=0)
    live = tx.init({"w": torch.zeros(20, 4)})
    moved = dataclasses.replace(live, adapt=live.adapt.replace(rung=1))
    bumped = dataclasses.replace(live, adapt=live.adapt.replace(
        err_sum=torch.tensor(0.5)))
    fps = [fingerprint_tree(replicated_view(s)).numpy()
           for s in (live, moved, bumped)]
    assert not np.array_equal(fps[0], fps[1])
    assert not np.array_equal(fps[0], fps[2])


def test_adapt_monitor_equals_jax():
    rows = [
        {"step": 0, "adapt_rung": 2.0, "fallback": 0.0},
        {"step": 1, "adapt_rung": 2.0, "fallback": 0.0},
        {"step": 2, "adapt_rung": 1.0, "fallback": 0.0},
        {"step": 3, "adapt_rung": 0.0, "fallback": 1.0},
        {"step": 4, "adapt_rung": 1.0, "fallback": 0.0},
        {"step": 5, "adapt_rung": 2.0, "fallback": 0.0},
        {"event": "watch", "step": 5},
        {"step": 6, "adapt_rung": -1.0},
    ]
    events = AdaptMonitor().observe(rows)
    assert events == JaxAdaptMonitor().observe(rows)
    assert [(e["event"], e["step"]) for e in events] == [
        ("adapt_tighten", 2), ("adapt_loosen", 5)]
    from grace_tpu_torch.telemetry.timeline import Timeline, classify
    assert classify({"event": "adapt_tighten"}) == "adapt"
    tl = Timeline.from_records(rows[:6] + events)
    assert tl.first("adapt").record["event"] == "adapt_tighten"
    assert tl.summary()["first_adapt_step"] == 2


def test_checkpoint_carries_adapt(group, tmp_path):
    from grace_tpu_torch.checkpoint import Checkpointer

    tx = grace_from_params(LIVE, group=group).transform(seed=1)
    grads = make_grads(1, 4, seed=2)
    st = tx.init({n: torch.zeros(s) for n, s in SHAPES.items()})
    for s in range(4):
        _, st = tx.update({n: torch.from_numpy(a[0, s].copy())
                           for n, a in grads.items()}, st)
    with Checkpointer(tmp_path / "ck", max_to_keep=None) as ckpt:
        ckpt.save(4, {"grace": st}, force=True)
        rep = torch.load(tmp_path / "ck" / "4" / "replicated.pt",
                         weights_only=False)
        assert rep["grace/adapt/rung"] == st.adapt.rung
        assert torch.equal(rep["grace/adapt/err_sum"], st.adapt.err_sum)
        back = ckpt.restore({"grace": tx.init(
            {n: torch.zeros(s) for n, s in SHAPES.items()})})["grace"]
        assert adapt_report(back) == adapt_report(st)
        assert torch.equal(back.adapt.err_sum, st.adapt.err_sum)
        # A checkpoint written before adapt existed (no such leaf)
        # restores into a state without it.
        plain = grace_from_params(STATIC, group=group).transform(seed=1)
        ckpt.save(5, {"grace": plain.init(
            {n: torch.zeros(s) for n, s in SHAPES.items()})}, force=True)
        step_dir = tmp_path / "ck" / "5"
        meta = json.loads((step_dir / "meta.json").read_text())
        meta["leaves"].pop("grace/adapt")
        (step_dir / "meta.json").write_text(json.dumps(meta))
        stored = torch.load(step_dir / "replicated.pt", weights_only=False)
        stored.pop("grace/adapt")
        torch.save(stored, step_dir / "replicated.pt")
        back = ckpt.restore({"grace": plain.init(
            {n: torch.zeros(s) for n, s in SHAPES.items()})}, step=5)
        assert back["grace"].adapt is None
        with pytest.raises(ValueError, match="grace/adapt"):
            ckpt.restore({"grace": tx.init(
                {n: torch.zeros(s) for n, s in SHAPES.items()})}, step=5)


def test_convert_carries_a_jax_adapt_state():
    from grace_tpu_torch.convert import grace_state_from_jax

    tx = jax_grace_from_params(LIVE).transform(seed=1)
    js = tx.init({n: jnp.zeros(s) for n, s in SHAPES.items()})
    js = js._replace(adapt=js.adapt._replace(
        rung=jnp.asarray(1, jnp.int32), err_sum=jnp.asarray(0.75,
                                                            jnp.float32),
        tightens=jnp.asarray(3, jnp.int32)))
    st = grace_state_from_jax(jax.device_get(js), seed=1)
    assert adapt_report({"g": st}) == {
        "rung": 1, "tightens": 3, "loosens": 0, "escalations": 0,
        "hold": 0, "quiet": 0, "last_change_step": -1}
    assert float(st.adapt.err_sum) == 0.75


# -- migrate_grace_state against JAX's ------------------------------------------

def _powersgd(rank, group=None):
    cfg = {"compressor": "powersgd", "compress_rank": rank,
           "memory": "powersgd", "communicator": "allreduce"}
    return cfg, grace_from_params(cfg, group=group)


@pytest.mark.parametrize("old_cfg,new_cfg", [
    ("powersgd2", "powersgd4"),
    ("homoqsgd", "powersgd4"),
    ("powersgd4", "powersgd4"),
])
def test_migrate_grace_state_equals_jax(group, old_cfg, new_cfg):
    from grace_tpu.transform import GraceState as JaxGraceState
    from grace_tpu.transform import \
        migrate_grace_state as jax_migrate_grace_state

    from grace_tpu_torch.transform import migrate_grace_state

    cfgs = {"powersgd2": _powersgd(2)[0], "powersgd4": _powersgd(4)[0],
            "homoqsgd": {"compressor": "homoqsgd", "quantum_num": 7,
                         "memory": "residual", "communicator": "allreduce",
                         "fusion": "flat"}}
    rng = np.random.default_rng(0)
    params = {"w1": rng.normal(size=(16, 8)).astype(np.float32),
              "w2": rng.normal(size=(8, 4)).astype(np.float32),
              "b": np.zeros(8, np.float32)}
    grads = {n: rng.normal(size=a.shape).astype(np.float32)
             for n, a in params.items()}
    # The old config's state (its count at 3, its residuals filled), then
    # migrated onto the new config's init; JAX's the same way.
    jold_tx = jax_grace_from_params(cfgs[old_cfg]).transform(seed=0)
    jnew_tx = jax_grace_from_params(cfgs[new_cfg]).transform(seed=0)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    jold = jold_tx.init(jp)
    jold = jold._replace(count=jnp.asarray(3, jnp.int32), mem=tuple(
        None if m is None else jnp.asarray(grads[n]).reshape(m.shape)
        if m.size == grads[n].size else m + 0.5
        for n, m in zip(sorted(params), jold.mem)))
    jmig, jstats = jax_migrate_grace_state(jold, jnew_tx.init(jp))
    assert isinstance(jmig, JaxGraceState)
    old_tx = grace_from_params(cfgs[old_cfg], group=group).transform(seed=0)
    new_tx = grace_from_params(cfgs[new_cfg], group=group).transform(seed=0)
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    old = old_tx.init(tp)
    old = dataclasses.replace(old, count=3, mem=[
        None if m is None else torch.from_numpy(np.asarray(jm).copy())
        for m, jm in zip(old.mem, jold.mem)])
    mig, stats = migrate_grace_state(old, new_tx.init(tp))
    assert stats == jstats
    assert mig.count == int(jmig.count) == 3
    for got, want in zip(mig.comp, jmig.comp):
        if want is None:
            assert got is None
            continue
        # PowerSGD's Q: JAX's up to each column's sign (LAPACK).
        g, w = got.numpy(), np.asarray(want)
        assert g.shape == w.shape
        np.testing.assert_allclose(np.abs(g), np.abs(w), rtol=1e-5,
                                   atol=1e-6)
    for got, want in zip(mig.mem, jmig.mem):
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_footprint_with_the_ladder_equals_jax(group):
    """The footprint model counts the controller's ten scalars in the
    bookkeeping, at JAX's widths; the per-rank parts scale with the world."""
    from grace_tpu.profiling import expected_state_footprint as jax_expected

    from grace_tpu_torch.profiling import check_state_footprint

    grc = grace_from_params(LIVE, group=group)
    state = grc.transform(seed=1).init({n: torch.zeros(s)
                                        for n, s in SHAPES.items()})
    want = jax_expected(jax_grace_from_params(LIVE),
                        {n: jnp.zeros(s) for n, s in SHAPES.items()},
                        world=WORLD)
    got = check_state_footprint(state, grc, {n: torch.zeros(s)
                                             for n, s in SHAPES.items()},
                                world=WORLD)
    assert got["matches"]
    for side in ("live", "model"):
        assert got[side] == want
    assert want["bookkeeping_bytes"] == 4 + 8 + 1 + 10 * 4


# -- the ladder in the auditor and the tuner (the JAX package's verdicts) --------

ADAPT_AUDITED = ("adapt-homoqsgd-ring", "adapt-topk-hier",
                 "adapt-guard-consensus")
# An int16-accumulated 8-bit rung under an int32-safe base rung
# (tests/test_adapt.py:489-495).
RUNG_BOUND = {"compressor": "homoqsgd", "quantum_num": 7,
              "accum_dtype": "int32", "memory": "residual",
              "communicator": "ring", "fusion": "flat", "escape": "fp16",
              "telemetry": True,
              "adapt": {"window": 5, "ladder": [
                  {"quantum_num": 127, "accum_dtype": "int16"}]}}


@pytest.mark.parametrize("name", ADAPT_AUDITED)
def test_adapt_registry_config_audits_clean_as_jax(name):
    from grace_tpu.analysis.configs import AUDIT_CONFIGS as JAX_CONFIGS
    from grace_tpu.analysis.configs import audit_config as jax_audit

    from grace_tpu_torch.analysis.configs import AUDIT_CONFIGS, audit_config

    (entry,) = [e for e in AUDIT_CONFIGS if e["name"] == name]
    (jentry,) = [e for e in JAX_CONFIGS if e["name"] == name]
    assert jax_audit(jentry) == []
    findings = audit_config(entry)
    assert findings == [], [f.message for f in findings]


def test_shared_scale_rung_bound_fires_statically_as_jax():
    """Flow pass 6 audits every reachable rung: the gentle 8-bit rung
    fires at W=512 where the base rung is safe, with JAX's bound and
    message head; clean at W=8."""
    import types

    from grace_tpu.analysis import flow as jflow
    from grace_tpu.analysis.trace import TracedGraph as JaxTracedGraph

    from grace_tpu_torch.analysis import flow

    grc = grace_from_params(RUNG_BOUND)
    jgrc = jax_grace_from_params(RUNG_BOUND)
    bound = grc.adapt.ladder[0].payload_sum_max_world()
    assert bound == jgrc.adapt.ladder[0].payload_sum_max_world()
    assert bound < 512 <= grc.compressor.payload_sum_max_world()
    for world in (512, 8):
        got = flow._shared_scale_findings(types.SimpleNamespace(
            name="adapt-rung-bound", world=world, meta={"grace": grc}))
        want = jflow._shared_scale_findings(JaxTracedGraph(
            name="adapt-rung-bound", closed=None, body=None, world=world,
            axis_name="data", varying={}, meta={"grace": jgrc}))
        # The message's head (up to the bound) is JAX's; its tail is the
        # port's own wording of the remedy.
        assert [(f.severity, f.message.split(" (")[0], dict(f.details))
                for f in got] == \
            [(f.severity, f.message.split(" (")[0], dict(f.details))
             for f in want]
        assert len(got) == (world == 512)


def test_adaptive_candidate_priced_at_steady_state_as_jax():
    """The adaptive candidate's projected step equals the static top rung's
    and its rung schedule (codec, rung, payload bytes) equals JAX's."""
    from grace_tpu.tuning.cost import TuneTopology as JaxTuneTopology
    from grace_tpu.tuning.cost import price_candidate as jax_price

    from grace_tpu_torch.tuning.cost import TuneTopology, price_candidate

    static = {"compressor": "homoqsgd", "quantum_num": 7,
              "memory": "residual", "communicator": "ring",
              "fusion": "flat"}
    adaptive = {**static, "escape": "fp16", "telemetry": 16,
                "adapt": {"window": 25, "ladder": [{"quantum_num": 127}]}}
    structs = {"w": ((4096, 64), torch.float32)}
    jstructs = {"w": jax.ShapeDtypeStruct((4096, 64), jnp.float32)}
    spec = TuneTopology(world=256, slice_size=8)
    jspec = JaxTuneTopology(world=256, slice_size=8)
    p_static = price_candidate(grace_from_params(static), structs, spec)
    p_adapt = price_candidate(grace_from_params(adaptive), structs, spec)
    j_adapt = jax_price(jax_grace_from_params(adaptive), jstructs, jspec)
    assert p_adapt["projected_step_ms"] == p_static["projected_step_ms"]
    assert p_adapt["steady_state_rung"] == j_adapt["steady_state_rung"] == 2
    keys = ("rung", "codec", "payload_bytes")
    assert [{k: r[k] for k in keys} for r in p_adapt["rung_prices"]] == \
        [{k: r[k] for k in keys} for r in j_adapt["rung_prices"]]
    rungs = p_adapt["rung_prices"]
    assert rungs[0]["codec"] == "FP16Compressor"
    assert (rungs[2]["projected_step_ms"] <= rungs[1]["projected_step_ms"]
            <= rungs[0]["projected_step_ms"])
    assert rungs[2]["payload_bytes"] == p_static["payload_bytes"]


def test_funnel_gates_every_rung_as_jax():
    from grace_tpu.tuning.candidates import Candidate as JaxCandidate
    from grace_tpu.tuning.candidates import \
        candidate_legal as jax_candidate_legal
    from grace_tpu.tuning.cost import TuneTopology as JaxTuneTopology
    from grace_tpu.tuning.prune import numeric_verdict as jax_numeric

    from grace_tpu_torch.tuning.candidates import Candidate, candidate_legal
    from grace_tpu_torch.tuning.cost import TuneTopology
    from grace_tpu_torch.tuning.prune import numeric_verdict

    grc, jgrc = grace_from_params(RUNG_BOUND), \
        jax_grace_from_params(RUNG_BOUND)
    for world in (8, 512):
        got = numeric_verdict(grc, TuneTopology(world=world))
        want = jax_numeric(jgrc, JaxTuneTopology(world=world))
        assert (got is None) == (want is None)
    assert "adapt rung" in got and "adapt rung" in want
    bad = {"compressor": "qsgd", "quantum_num": 15, "use_pallas": False,
           "memory": "none", "communicator": "ring", "fusion": "flat",
           "escape": "fp16", "telemetry": True,
           "adapt": {"window": 5, "ladder": [{"compressor": "onebit"}]}}
    legal, reason, _ = candidate_legal(Candidate("bad-adapt-rung", bad),
                                       TuneTopology(world=8))
    jlegal, jreason, _ = jax_candidate_legal(
        JaxCandidate("bad-adapt-rung", bad), JaxTuneTopology(world=8))
    assert legal is jlegal is False
    assert "adapt rung" in reason and "adapt rung" in jreason


def test_generated_adaptive_variant_is_legal_and_priced_as_jax():
    from grace_tpu.tuning.candidates import \
        generated_variants as jax_generated
    from grace_tpu.tuning.cost import TuneTopology as JaxTuneTopology

    from grace_tpu_torch.tuning.candidates import (candidate_legal,
                                                   generated_variants)
    from grace_tpu_torch.tuning.cost import TuneTopology, price_candidate

    name = "tune-adapt-homoqsgd4-ring"
    (cand,) = [c for c in generated_variants(TuneTopology(world=8))
               if c.name == name]
    (jcand,) = [c for c in jax_generated(JaxTuneTopology(world=8))
                if c.name == name]
    assert cand.params == jcand.params
    legal, reason, grace = candidate_legal(cand, TuneTopology(world=8))
    assert legal, reason
    price = price_candidate(grace, {"w": ((512,), torch.float32)},
                            TuneTopology(world=8))
    assert [r["rung"] for r in price["rung_prices"]] == [0, 1, 2]


def test_adapt_trail_matches_the_telemetry_report_tool():
    """The ladder's trail of ``telemetry.report`` against the repository's
    ``tools/telemetry_report.py`` (loaded read-only), on JAX's test rows
    (tests/test_adapt.py:627-661) and on a run without rows."""
    import importlib.util
    import os

    from grace_tpu_torch.telemetry.report import render_adapt, render_trails

    spec = importlib.util.spec_from_file_location(
        "telemetry_report_port_adapt", os.path.join(
            os.path.dirname(__file__), os.pardir, "tools",
            "telemetry_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    records = [{"step": i, "adapt_rung": float(2 - (i >= 3)),
                "adapt_bytes": 14.0, "wire_bytes": 100.0,
                "dense_bytes": 336.0} for i in range(6)]
    events = [{"event": "adapt_tighten", "step": 3, "rung": 1,
               "from_rung": 2},
              {"event": "adapt_loosen", "step": 5, "rung": 2,
               "from_rung": 1}]
    for recs, evs in ((records, events), ([], events[:1]),
                      ([{"step": 0, "adapt_rung": -1.0}], [])):
        assert render_adapt(evs, recs) == report._render_adapt(evs, recs)
    text = report.render(None, records, events)
    trail = "\n".join(render_trails(records, events))
    assert "== adapt (graft-adapt rung transitions) ==" in trail
    assert "1 tighten(s), 1 loosen(s)" in trail and trail in text
