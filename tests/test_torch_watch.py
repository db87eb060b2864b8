"""The port's cross-rank watch ring, anomaly detectors and timeline against
the JAX package's, on the CPU.

* Four gloo ranks against JAX's four-device mesh, Top-K 30% chunk with a
  ``ChaosCompressor`` drifting rank 2's payload by 90%: every rank's watch
  ring equals JAX's (step ids, ``skew_rank`` and ``watch_bytes`` exact;
  the means, extremes and skews within rtol 1e-5 and atol 1e-6, as the
  compression error's and the norms' sums run in another order), and so
  do the reader's watch records. ``skew_rank`` is the drifting rank.
  ``watch_bytes`` (the gather's 36 B) rides in ``wire_bytes`` and in
  ``wire_bytes_ici`` on window rows only.
* A tie: every rank with the same gradients, so every relative deviation
  is 0: ``skew_rank`` 0 in both packages (the first index).
* The seeded drift flagged by ``TelemetryReader(anomaly=True)`` for rank 2
  at the first window, on the compression error; the healthy twin raises
  no anomaly.
* A skipped step on a window boundary rolls the watch row back: the row of
  that step comes from the next, accepted one, and every value is finite.
* A flush with the watch ring armed is still one device-to-host transfer.
* ``WatchMonitor`` and ``Timeline`` (pure host code) give JAX's records on
  the same inputs, a JSONL with a torn tail included.
* The spellings, the "requires telemetry" error, the checkpoint's per-rank
  ``watch`` and an old checkpoint without ``audit``/``watch``, and a JAX
  ``WatchState`` carried by ``convert``.
"""

import copy
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh, PartitionSpec as P

from grace_tpu import grace_from_params as jax_grace_from_params
from grace_tpu.parallel import shard_map
from grace_tpu.resilience import ChaosCompressor as JaxChaosCompressor
from grace_tpu.telemetry import TelemetryReader as JaxReader
from grace_tpu.telemetry import Timeline as JaxTimeline
from grace_tpu.telemetry import WatchMonitor as JaxWatchMonitor
from grace_tpu.telemetry.aggregate import WATCH_FIELDS as JAX_WATCH_FIELDS
from grace_tpu.telemetry.aggregate import WatchState as JaxWatchState

from grace_tpu_torch import grace_from_params
from grace_tpu_torch.resilience import ChaosCompressor, guarded_chain
from grace_tpu_torch.telemetry import (AnomalyConfig, TelemetryReader,
                                       Timeline, WatchConfig, WatchMonitor)
from grace_tpu_torch.telemetry.aggregate import (WATCH_FIELDS,
                                                 normalize_watch,
                                                 watch_gather_bytes)
from grace_tpu_torch.telemetry.anomaly import Ewma
from grace_tpu_torch.telemetry.timeline import classify

WORLD = 4
STEPS = 11
WINDOW = 5
DRIFT_RANK = 2
DRIFT = 0.9          # rank 2's payload values scaled by 0.1
TIMEOUT_S = 240
SHAPES = {"h1": (12, 12), "b1": (12,), "w": (12, 3), "b": (3,)}
WATCHED = {"compressor": "topk", "compress_ratio": 0.3,
           "topk_algorithm": "chunk", "memory": "residual",
           "communicator": "allgather", "telemetry": 64, "watch": WINDOW}
EXACT = ("skew_rank", "watch_bytes")


def make_grads(steps, seed=0, same=False):
    rng = np.random.default_rng(seed)
    g = {n: (rng.standard_normal((WORLD, steps) + s) * 0.5).astype(
        np.float32) for n, s in SHAPES.items()}
    if same:
        g = {n: np.repeat(a[:1], WORLD, axis=0) for n, a in g.items()}
    return g


def run_jax(grads, steps, drift):
    """JAX's watch and telemetry rings after ``steps`` updates on a
    four-device mesh, rank ``DRIFT_RANK``'s encoder drifting (or not)."""
    import dataclasses

    grc = jax_grace_from_params(WATCHED)
    if drift:
        grc = dataclasses.replace(grc, compressor=JaxChaosCompressor(
            inner=grc.compressor, drift_scale=DRIFT, rank=DRIFT_RANK))
    tx = grc.transform(seed=1)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))

    def body(g):
        g = jax.tree.map(lambda a: a[0], g)
        state = tx.init(jax.tree.map(lambda a: a[0], g))
        for s in range(steps):
            _, state = tx.update(jax.tree.map(lambda a: a[s], g), state)
        return (state.watch.rings[None], state.watch.steps[None],
                state.telem.rings[None])

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),),
                           out_specs=P("data"), check_vma=False))
    rings, steps_, telem = fn({n: jnp.asarray(a) for n, a in grads.items()})
    return np.asarray(rings), np.asarray(steps_), np.asarray(telem)


def run_port(grads, steps, group, rank, drift, reader=None):
    grc = grace_from_params(WATCHED, group=group)
    if drift:
        import dataclasses
        grc = dataclasses.replace(grc, compressor=ChaosCompressor(
            inner=grc.compressor, drift_scale=DRIFT, rank=DRIFT_RANK,
            group=group))
    tx = grc.transform(seed=1)
    state = tx.init({n: torch.from_numpy(a[rank, 0].copy())
                     for n, a in grads.items()})
    records = []
    for s in range(steps):
        _, state = tx.update({n: torch.from_numpy(a[rank, s].copy())
                              for n, a in grads.items()}, state)
        if reader is not None:
            records += reader.update(s, state)
    return state, records


def _worker(rank, init_file, paths, out_paths):
    from grace_tpu_torch.parallel import init_process_group

    group, _ = init_process_group("cpu", rank=rank, world_size=WORLD,
                                  init_method=f"file://{init_file}")
    try:
        out = {}
        for label, (path, steps, drift) in paths.items():
            with np.load(path) as data:
                grads = {n: data[n] for n in data.files}
            state, _ = run_port(grads, steps, group, rank, drift)
            out[f"{label}/rings"] = state.watch.rings.numpy()
            out[f"{label}/steps"] = state.watch.steps.numpy()
            out[f"{label}/telem"] = state.telem.rings.numpy()
            records = TelemetryReader(every=steps).flush(state)
            out[f"{label}/records"] = np.frombuffer(
                json.dumps(records).encode(), dtype=np.uint8)
        # The detectors over two flushes, drifting and healthy.
        with np.load(paths["drift"][0]) as data:
            grads = {n: data[n] for n in data.files}
        for label, drift in (("anomaly_drift", True),
                             ("anomaly_healthy", False)):
            reader = TelemetryReader(every=STEPS // 2 + 1, anomaly=True)
            state, records = run_port(grads, STEPS, group, rank, drift,
                                      reader)
            records += reader.flush(state)
            out[label] = np.frombuffer(json.dumps(records).encode(),
                                       dtype=np.uint8)
        np.savez(out_paths[rank], **out)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("watch")
    runs = {"drift": (make_grads(STEPS, seed=3), STEPS, True),
            "tie": (make_grads(1, seed=4, same=True), 1, False)}
    paths = {}
    for label, (grads, steps, drift) in runs.items():
        path = str(tmp / f"{label}.npz")
        np.savez(path, **grads)
        paths[label] = (path, steps, drift)
    outs = [tmp / f"rank{r}.npz" for r in range(WORLD)]
    ctx = mp.start_processes(
        _worker, args=(str(tmp / "store"), paths, [str(o) for o in outs]),
        nprocs=WORLD, join=False, start_method="spawn")
    ref = {label: run_jax(grads, steps, drift)
           for label, (grads, steps, drift) in runs.items()}
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


def _assert_watch_rings_equal(got, want):
    for fi, (name, _) in enumerate(WATCH_FIELDS):
        if name in EXACT:
            np.testing.assert_array_equal(got[..., fi], want[..., fi],
                                          err_msg=name)
        else:
            np.testing.assert_allclose(got[..., fi], want[..., fi],
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_watch_fields_equal_jax():
    assert WATCH_FIELDS == JAX_WATCH_FIELDS
    assert [watch_gather_bytes(w) for w in (1, 4, 8)] == [0, 36, 84]


def test_watch_rings_equal_jax_at_four_ranks(four_ranks):
    port, ref = four_ranks
    jrings, jsteps, _ = ref["drift"]
    for r in range(WORLD):
        np.testing.assert_array_equal(port[r]["drift/steps"], jsteps[r])
        _assert_watch_rings_equal(port[r]["drift/rings"], jrings[r])
    rows = np.flatnonzero(jsteps[0] >= 0)
    assert jsteps[0][rows].tolist() == [0, 5, 10]
    assert set(jrings[0][rows, WATCH_FIELDS.index(("skew_rank", "first"))]
               .tolist()) == {float(DRIFT_RANK)}


def test_watch_records_equal_jax(four_ranks):
    port, ref = four_ranks
    jrings, jsteps, _ = ref["drift"]
    want = [r for r in JaxReader(every=STEPS).flush(JaxWatchState(
        rings=jnp.asarray(jrings), steps=jnp.asarray(jsteps)))]
    for r in range(WORLD):
        got = [g for g in json.loads(port[r]["drift/records"].tobytes())
               if g.get("event") == "watch"]
        assert [g["step"] for g in got] == [w["step"] for w in want]
        for g, w in zip(got, want):
            assert g["skew_rank"] == w["skew_rank"] == DRIFT_RANK
            for name, _ in WATCH_FIELDS:
                np.testing.assert_allclose(g[name], w[name], rtol=1e-5,
                                           atol=1e-6, err_msg=name)


def test_watch_bytes_fold_into_the_wire_accounting(four_ranks):
    port, ref = four_ranks
    _, _, jtelem = ref["drift"]
    telem = port[0]["drift/telem"][:STEPS]
    names = {name: i for i, (name, _) in
             enumerate(__import__("grace_tpu_torch.telemetry.state",
                                  fromlist=["FIELDS"]).FIELDS)}
    gb = watch_gather_bytes(WORLD)
    base = telem[1, names["wire_bytes"]]
    for s in range(STEPS):
        extra = gb if s % WINDOW == 0 else 0.0
        assert telem[s, names["watch_bytes"]] == extra
        assert telem[s, names["wire_bytes"]] == base + extra
        assert telem[s, names["wire_bytes_ici"]] == base + extra
    for name in ("watch_bytes", "wire_bytes", "wire_bytes_ici"):
        np.testing.assert_array_equal(telem[:, names[name]],
                                      jtelem[0][:STEPS, names[name]])


def test_skew_rank_tie_is_the_first_rank(four_ranks):
    port, ref = four_ranks
    jrings, jsteps, _ = ref["tie"]
    col = WATCH_FIELDS.index(("skew_rank", "first"))
    assert jrings[0, 0, col] == 0.0
    for r in range(WORLD):
        _assert_watch_rings_equal(port[r]["tie/rings"], jrings[r])
        assert port[r]["tie/rings"][0, col] == 0.0
        assert port[r]["tie/rings"][0, WATCH_FIELDS.index(
            ("skew_max", "first"))] == 0.0


def test_seeded_drift_flagged_for_its_rank_within_one_window(four_ranks):
    """Attribution judged on the compression error, the codec-health
    signal the drift corrupts (ROADMAP queue 3: the JAX smoke's
    residual-norm skew can follow a rank's gradient norm)."""
    port, _ = four_ranks
    for r in range(WORLD):
        records = json.loads(port[r]["anomaly_drift"].tobytes())
        skews = [a for a in records if a.get("event") == "watch_anomaly"
                 and a["kind"] == "skew"
                 and a["metric"] == "compression_error"]
        assert skews and {a["rank"] for a in skews} == {DRIFT_RANK}
        assert min(a["step"] for a in skews) == 0
        healthy = json.loads(port[r]["anomaly_healthy"].tobytes())
        assert not [a for a in healthy if a.get("event") == "watch_anomaly"]


# -- one rank -------------------------------------------------------------------

@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


def test_skipped_step_rolls_the_watch_row_back(group):
    """Update 5 (a window boundary) is poisoned and skipped; the count-5
    row comes from the next, accepted update; nothing non-finite."""
    chain = guarded_chain(grace_from_params({**WATCHED, "escape": "fp16"},
                                            group=group))
    grads = make_grads(9, seed=5)
    grads["h1"][0, 5, 0, 0] = np.nan
    ps = {n: torch.nn.Parameter(torch.zeros(s)) for n, s in SHAPES.items()}
    opt = torch.optim.SGD(ps.values(), lr=0.25)
    st = chain.init(ps)
    for s in range(9):
        st = chain.apply(ps, {n: torch.from_numpy(a[0, s].copy())
                              for n, a in grads.items()}, st, opt)
    records = TelemetryReader(every=100).flush(st)
    watch = [r for r in records if r.get("event") == "watch"]
    assert [r["step"] for r in watch] == [0, 5]
    for rec in watch:
        for name, agg in WATCH_FIELDS:
            vals = rec[name] if agg == "gather" else [rec[name]]
            assert all(np.isfinite(v) for v in vals), (rec["step"], name)
    assert [r["step"] for r in records if "wire_bytes" in r] == \
        list(range(8))


def test_flush_is_one_transfer_with_watch_armed(group, monkeypatch):
    calls = [0]
    cpu = torch.Tensor.cpu

    def counting(self, *a, **k):
        calls[0] += 1
        return cpu(self, *a, **k)

    chain = guarded_chain(grace_from_params({**WATCHED, "escape": "fp16"},
                                            group=group))
    ps = {n: torch.nn.Parameter(torch.zeros(s)) for n, s in SHAPES.items()}
    opt = torch.optim.SGD(ps.values(), lr=0.25)
    st = chain.init(ps)
    reader = TelemetryReader(every=10, anomaly=True)
    grads = make_grads(20, seed=6)
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    per_flush = []
    for i in range(20):
        st = chain.apply(ps, {n: torch.from_numpy(a[0, i].copy())
                              for n, a in grads.items()}, st, opt)
        before = calls[0]
        out = reader.update(i, st)
        if out:
            per_flush.append(calls[0] - before)
            assert any(r.get("event") == "watch" for r in out)
    assert reader.flushes == 2 and per_flush == [1, 1]


def test_watch_requires_telemetry_and_its_spellings():
    cfg = {k: v for k, v in WATCHED.items() if k != "telemetry"}
    with pytest.raises(ValueError, match="requires telemetry"):
        grace_from_params(cfg).transform(seed=0)
    assert normalize_watch(None) is None and normalize_watch(False) is None
    assert normalize_watch(True) == WatchConfig()
    assert normalize_watch(7) == WatchConfig(window=7)
    assert normalize_watch({"window": 3, "capacity": 4}) \
        == WatchConfig(window=3, capacity=4)
    with pytest.raises(TypeError):
        normalize_watch("yes")
    with pytest.raises(ValueError, match="watch window must be >= 1"):
        WatchConfig(window=0)


def test_watch_needs_a_ring_in_the_state(group):
    plain = grace_from_params({**WATCHED, "watch": None}, group=group)
    ps = {n: torch.zeros(s) for n, s in SHAPES.items()}
    state = plain.transform(seed=1).init(ps)
    tx = grace_from_params(WATCHED, group=group).transform(seed=1)
    with pytest.raises(ValueError, match="no watch ring"):
        tx.update(ps, state)


# -- the detectors and the timeline -------------------------------------------------

def _watch_row(step, skew, mean=0.5):
    return {"event": "watch", "step": step, "compression_error_mean": mean,
            "compression_error_skew": list(skew), "grad_norm_mean": 1.0,
            "grad_norm_skew": [0.0] * len(skew), "residual_norm_mean": 1.0,
            "residual_norm_skew": [0.0] * len(skew)}


def _detector_records():
    rng = np.random.default_rng(7)
    recs = []
    for s in range(0, 60, 5):
        skew = rng.normal(0.0, 0.01, 8)
        if 10 <= s < 25:
            skew[3] = 0.3                       # an episode on rank 3
        if s == 40:
            skew[6] = -0.4
        recs.append(_watch_row(s, skew.tolist(),
                               mean=0.5 + (2.0 if s == 45 else 0.0)))
        recs.append({"step": s, "wire_bytes": 1000.0 + (5000.0 if s == 50
                                                        else 0.0),
                     "audit_bytes": 100.0 if s % 10 == 0 else 0.0,
                     "watch_bytes": 84.0, "fallback": 0.0})
        recs.append({"event": "perf_step_times", "step": s,
                     "p50_ms": 10.0 + (30.0 if s == 35 else 0.01 * s)})
    recs.append({"event": "perf_retrace", "step": 55, "cache_size": 2,
                 "retraces": 1})
    recs.append("not a record")
    return recs


@pytest.mark.parametrize("config", [None, {"warmup": 2, "skew_floor": 0.01},
                                    {"z_threshold": 2.5, "ewma_alpha": 0.5}])
def test_watch_monitor_equals_jax(config):
    from grace_tpu.telemetry import AnomalyConfig as JaxAnomalyConfig

    recs = _detector_records()
    got_sink, want_sink = [], []

    class Sink(list):
        def write(self, r):
            self.append(dict(r))

    got_sink, want_sink = Sink(), Sink()
    port = WatchMonitor(sink=got_sink, config=(
        AnomalyConfig(**config) if config else None))
    ref = JaxWatchMonitor(sink=want_sink, config=(
        JaxAnomalyConfig(**config) if config else None))
    half = len(recs) // 2
    got = port.observe(recs[:half]) + port.observe(recs[half:])
    want = ref.observe(recs[:half]) + ref.observe(recs[half:])
    assert got == want and got_sink == want_sink
    assert {a["kind"] for a in got} >= {"skew", "retrace"}
    assert port.anomalies == ref.anomalies


def test_ewma_equals_jax():
    from grace_tpu.telemetry.anomaly import Ewma as JaxEwma
    a, b = Ewma(alpha=0.25, warmup=2), JaxEwma(alpha=0.25, warmup=2)
    for x in (1.0, 1.0, 1.0, 100.0, 2.0, -3.0):
        assert a.update(x) == b.update(x)


def _timeline_records():
    return [
        {"provenance": {"tool": "test"}},
        {"step": 0, "grad_norm": 1.0, "wire_bytes": 100.0},
        {"event": "watch", "step": 0, "skew_max": 0.1, "skew_rank": 2,
         "compression_error_mean": 0.4},
        {"event": "watch_anomaly", "step": 0, "kind": "skew",
         "metric": "compression_error", "rank": 2, "score": 9.0},
        {"step": 1, "grad_norm": 0.9, "wire_bytes": 100.0},
        {"event": "guard_skip", "step": 2, "notfinite_count": 1},
        {"event": "consensus_repair", "step": 3, "repairs": 1},
        {"event": "consensus_escalation", "step": 3, "escalations": 1},
        {"event": "perf_step_times", "step": 3, "p50_ms": 1.0},
        {"event": "lint_finding", "step": 3, "severity": "error"},
        {"event": "elastic_resize", "step": 4},
        {"event": "adapt_rung", "step": 4, "rung": 1},
        {"event": "retune_promote", "step": 5},
        {"event": "something_new", "step": 5},
        {"event": "guard_only", "guard_step": 4},
    ]


def _timeline_view(tl):
    return ([(e.step, e.kind, e.seq, e.record, e.brief()) for e in tl],
            tl.summary(), tl.render(), tl.render(kinds=["guard"], limit=1),
            tl.steps(), tl.provenance)


def test_timeline_equals_jax():
    recs = _timeline_records()
    for r in recs:
        assert classify(r) == __import__(
            "grace_tpu.telemetry.timeline", fromlist=["classify"]).classify(r)
    got = Timeline.from_records(copy.deepcopy(recs))
    want = JaxTimeline.from_records(copy.deepcopy(recs))
    assert _timeline_view(got) == _timeline_view(want)
    assert [e.kind for e in got.at_step(0)] == ["telemetry", "watch",
                                                "anomaly"]
    assert [e.kind for e in got.between(2, 3)] == \
        ["guard", "consensus", "consensus", "perf", "lint"]
    assert got.summary()["anomalous_ranks"] == [2]
    with pytest.raises(ValueError):
        got.kinds("nonsense")


def test_timeline_from_jsonl_with_a_torn_tail_equals_jax(tmp_path):
    path = tmp_path / "run.jsonl"
    path.write_text("".join(json.dumps(r) + "\n"
                            for r in _timeline_records()[:6])
                    + '{"step": 6, "grad_no')          # killed mid-line
    got, want = Timeline.from_jsonl(str(path)), JaxTimeline.from_jsonl(
        str(path))
    assert _timeline_view(got) == _timeline_view(want)
    assert len(got) == 5 and got.provenance == {"tool": "test"}


# -- state at rest ------------------------------------------------------------------

def test_checkpoint_keeps_the_watch_ring_per_rank(group, tmp_path):
    from grace_tpu_torch.checkpoint import Checkpointer

    tx = grace_from_params(WATCHED, group=group).transform(seed=1)
    grads = make_grads(6, seed=8)
    st = tx.init({n: torch.zeros(s) for n, s in SHAPES.items()})
    for s in range(6):
        _, st = tx.update({n: torch.from_numpy(a[0, s].copy())
                           for n, a in grads.items()}, st)
    with Checkpointer(tmp_path / "ck", max_to_keep=None) as ckpt:
        ckpt.save(0, {"grace": st}, force=True)
        rank0 = torch.load(tmp_path / "ck" / "0" / "rank0.pt",
                           weights_only=False)
        assert torch.equal(rank0["grace/watch/rings"], st.watch.rings)
        back = ckpt.restore({"grace": tx.init(
            {n: torch.zeros(s) for n, s in SHAPES.items()})})
        assert torch.equal(back["grace"].watch.rings, st.watch.rings)
        assert torch.equal(back["grace"].watch.steps, st.watch.steps)


def test_checkpoint_without_the_new_fields_restores(group, tmp_path):
    """A checkpoint written before ``audit`` and ``watch`` existed (no such
    leaves) restores into a state without them."""
    from grace_tpu_torch.checkpoint import Checkpointer

    cfg = {k: v for k, v in WATCHED.items() if k != "watch"}
    tx = grace_from_params(cfg, group=group).transform(seed=1)
    st = tx.init({n: torch.zeros(s) for n, s in SHAPES.items()})
    with Checkpointer(tmp_path / "ck", max_to_keep=None) as ckpt:
        ckpt.save(0, {"grace": st}, force=True)
        step_dir = tmp_path / "ck" / "0"
        meta = json.loads((step_dir / "meta.json").read_text())
        for path in ("grace/audit", "grace/watch"):
            meta["leaves"].pop(path)
        (step_dir / "meta.json").write_text(json.dumps(meta))
        for name in ("replicated.pt", "rank0.pt"):
            stored = torch.load(step_dir / name, weights_only=False)
            stored.pop("grace/audit", None)
            stored.pop("grace/watch", None)
            torch.save(stored, step_dir / name)
        back = ckpt.restore({"grace": tx.init(
            {n: torch.zeros(s) for n, s in SHAPES.items()})})
        assert back["grace"].audit is None and back["grace"].watch is None
        armed = grace_from_params(WATCHED, group=group).transform(seed=1)
        with pytest.raises(ValueError, match="grace/watch/rings"):
            ckpt.restore({"grace": armed.init(
                {n: torch.zeros(s) for n, s in SHAPES.items()})})


def test_convert_carries_a_jax_watch_state():
    from grace_tpu_torch.convert import grace_state_from_jax
    jstate = jax_grace_from_params(WATCHED).transform(seed=1).init(
        {n: jnp.zeros(s) for n, s in SHAPES.items()})
    rings = jnp.arange(16 * len(WATCH_FIELDS), dtype=jnp.float32).reshape(
        16, len(WATCH_FIELDS))
    jstate = jstate._replace(watch=JaxWatchState(
        rings=rings, steps=jnp.arange(16, dtype=jnp.int32)))
    got = grace_state_from_jax(jax.device_get(jstate), seed=1)
    np.testing.assert_array_equal(got.watch.rings.numpy(), np.asarray(rings))
    assert got.watch.steps.tolist() == list(range(16))
