"""The port's telemetry against the JAX package's, on the CPU.

* The ring: for ``fusion`` None, ``'flat'``, ``'grouped'`` and byte
  buckets, a routed table, and an escape window (the fallback flag set by
  hand, as JAX's own telemetry tests do), the port's ``telemetry=True``
  ring equals JAX's after the same steps: at one rank, and at four gloo
  ranks against JAX's four-device mesh (each rank's ring, and the
  reader's aggregated records). Byte columns and step ids as exact
  integers, norms within rtol 1e-6 (the sums run in another order),
  the compression error within rtol 1e-5.
* The reader: one transfer a flush, wraparound counted, contiguous
  windows, the guard's counters in the flush.
* The sinks: ``TensorBoardSink`` writes JAX's bytes for the same records
  and wall times; the JSONL header once; ``MultiSink``; the report tool
  renders the port's JSONL; ``GuardMonitor``'s transition edges.
* The schema: ``FIELDS``, the stage names and ``match_stage``, the
  escape's spellings and error, and the invalid spellings of
  ``consensus``, ``watch`` and ``adapt``.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh, PartitionSpec as P

from grace_tpu import grace_from_params as jax_grace_from_params
from grace_tpu.parallel import shard_map
from grace_tpu.telemetry import TelemetryReader as JaxReader
from grace_tpu.telemetry import scopes as jax_scopes
from grace_tpu.telemetry import sinks as jax_sinks
from grace_tpu.telemetry.state import FIELDS as JAX_FIELDS
from grace_tpu.telemetry.state import TelemetryState as JaxTelemetryState
from grace_tpu.transform import set_fallback_flag as jax_set_fallback_flag

from grace_tpu_torch import grace_from_params
from grace_tpu_torch.telemetry import (FIELDS, JSONLSink, MultiSink,
                                       TelemetryConfig, TelemetryReader,
                                       TelemetryState, TensorBoardSink)
from grace_tpu_torch.telemetry import scopes
from grace_tpu_torch.transform import leaf_order, set_fallback_flag
from grace_tpu_torch.utils.logging import GuardMonitor, run_provenance

STEPS = 4
WORLD = 4
TIMEOUT_S = 240
SHAPES = {"h1": (12, 12), "h2": (12, 12), "b1": (12,), "b2": (12,),
          "w": (12, 3), "b": (3,)}
TOPK = {"compressor": "topk", "compress_ratio": 0.3,
        "topk_algorithm": "chunk", "memory": "residual",
        "communicator": "allgather", "telemetry": True}
FP16_DENSE = {"compressor": "fp16", "memory": "none",
              "communicator": "allreduce"}
# name -> (params, steps whose update runs with the fallback flag set)
CASES = {
    "per_leaf": (TOPK, ()),
    "flat": ({**TOPK, "fusion": "flat"}, ()),
    "grouped": ({**TOPK, "fusion": "grouped"}, ()),
    "bucketed": ({**TOPK, "fusion": 512}, ()),
    "routed": ({**TOPK, "route": [("b*", FP16_DENSE)]}, ()),
    "escape_window": ({**TOPK, "escape": "fp16"}, (1, 2)),
}
# The routed biases and the escape window sum fp16 payloads across ranks:
# XLA's CPU psum adds them in rank order, rounding each add to fp16, and
# gloo adds them in its own order, so at four ranks their means part by an
# fp16 rounding on some lanes. The update's norm is held to this there.
FP16_SUM_RTOL = 2e-4
FP16_SUM_CASES = ("routed", "escape_window")
EXACT = ("wire_bytes", "dense_bytes", "fallback", "audit_bytes",
         "wire_bytes_ici", "wire_bytes_dcn", "wire_bytes_wan", "watch_bytes",
         "negotiation_bytes", "adapt_rung", "adapt_bytes")
NORMS = ("grad_norm", "update_norm", "residual_norm", "residual_max")


def make_grads(world, seed=0):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal((world, STEPS) + s) * 0.5).astype(
        np.float32) for n, s in SHAPES.items()}


def run_jax(cfg, grads, flags, world=1):
    """JAX's ring after ``STEPS`` updates on a ``world``-device submesh:
    ``(rings (world, capacity, F), steps (world, capacity))``."""
    tx = jax_grace_from_params(cfg).transform(seed=1)
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))

    def body(g):
        g = jax.tree.map(lambda a: a[0], g)
        state = tx.init(jax.tree.map(lambda a: a[0], g))
        for s in range(STEPS):
            state = jax_set_fallback_flag(state, s in flags)
            _, state = tx.update(jax.tree.map(lambda a: a[s], g), state)
        return state.telem.rings[None], state.telem.steps[None]

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),),
                           out_specs=P("data"), check_vma=False))
    rings, steps = fn({n: jnp.asarray(a[:world]) for n, a in grads.items()})
    return np.asarray(rings), np.asarray(steps)


def run_port(cfg, grads, flags, group, rank=0):
    """The port's ring after the same updates of rank ``rank``'s
    gradients, and the transform's state."""
    tx = grace_from_params(cfg, group=group).transform(seed=1)
    state = tx.init({n: torch.from_numpy(a[rank, 0].copy())
                     for n, a in grads.items()})
    for s in range(STEPS):
        state = set_fallback_flag(state, s in flags)
        _, state = tx.update({n: torch.from_numpy(a[rank, s].copy())
                              for n, a in grads.items()}, state)
    return state.telem.rings.numpy(), state.telem.steps.numpy(), state


def norm_rtol(name, case=None, world=1):
    if name == "update_norm" and world > 1 and case in FP16_SUM_CASES:
        return FP16_SUM_RTOL
    return 1e-6 if name in NORMS else 1e-5


def assert_ring_equal(rings, steps, jrings, jsteps, case=None, world=1):
    np.testing.assert_array_equal(steps, jsteps)
    assert rings.shape == jrings.shape
    for fi, (name, _) in enumerate(FIELDS):
        got, want = rings[..., fi], jrings[..., fi]
        if name in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name in NORMS:
            np.testing.assert_allclose(got, want, rtol=norm_rtol(
                name, case, world), err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=name)


@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


# -- the schema ---------------------------------------------------------------

def test_fields_and_stages_equal_jax():
    assert FIELDS == JAX_FIELDS
    # The JAX package's stages in its order, beside the port's own train
    # step stages, which its one jitted step has no host boundary for.
    assert tuple(s for s in scopes.ALL_STAGES
                 if s not in scopes.PORT_STAGES) == jax_scopes.ALL_STAGES
    assert not set(scopes.PORT_STAGES) & set(jax_scopes.ALL_STAGES)
    for path in ("grace/optimizer/grace/exchange/grace/decompress",
                 "grace/exchange/psum_vote", "grace/bucket/3",
                 "x/grace/custom/y", "no_stage_here", "grace/telemetry"):
        assert scopes.match_stage(path) == jax_scopes.match_stage(path)
    with pytest.raises(ValueError, match="capacity"):
        TelemetryConfig(capacity=0)


def test_trace_stage_records_a_span_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile
    with scopes.trace_stage(scopes.STAGE_COMPRESS):   # no profiler: nothing
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with scopes.trace_stage(scopes.STAGE_COMPRESS):
            torch.ones(3).sum()
    assert scopes.STAGE_COMPRESS in {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("spelling,dtype", [("none", None), ("dense", None),
                                            ("fp16", torch.float16),
                                            ("bf16", torch.bfloat16),
                                            ("bfloat16", torch.bfloat16)])
def test_escape_spellings(spelling, dtype):
    from grace_tpu_torch.compressors import FP16Compressor, NoneCompressor
    grc = grace_from_params({**TOPK, "escape": spelling})
    if dtype is None:
        assert isinstance(grc.escape, NoneCompressor)
    else:
        assert isinstance(grc.escape, FP16Compressor)
        assert grc.escape.compress(torch.ones(2), None, None)[0][0].dtype \
            == dtype


def test_escape_refusals():
    with pytest.raises(ValueError, match="unknown escape compressor"):
        grace_from_params({**TOPK, "escape": "topk"})
    grc = grace_from_params(TOPK)
    from grace_tpu_torch.transform import grace_transform
    with pytest.raises(ValueError, match="dense, summable, averaging"):
        grace_transform(grc.compressor, grc.memory, grc.communicator,
                        escape=grc.compressor)


# key -> (a spelling that must raise, JAX's message). consensus, watch and
# adapt build since they were ported; their invalid spellings raise JAX's
# errors at build.
RAISING_KEYS = {
    "consensus": ({"consensus": 0}, "audit_every must be >= 1"),
    "watch": ({"watch": {"window": 0}}, "watch window must be >= 1"),
    "adapt": ({"adapt": {"window": 0}}, "adapt window must be >= 1"),
}


@pytest.mark.parametrize("key", list(RAISING_KEYS))
def test_unported_resilience_keys_still_raise(key):
    extra, message = RAISING_KEYS[key]
    with pytest.raises(ValueError, match=message):
        grace_from_params({**TOPK, **extra})


def test_telemetry_needs_a_ring_in_the_state(group):
    grads = make_grads(1)
    plain = grace_from_params({k: v for k, v in TOPK.items()
                               if k != "telemetry"}, group=group)
    state = plain.transform(seed=1).init(
        {n: torch.from_numpy(a[0, 0]) for n, a in grads.items()})
    tx = grace_from_params(TOPK, group=group).transform(seed=1)
    with pytest.raises(ValueError, match="no telemetry ring"):
        tx.update({n: torch.from_numpy(a[0, 0].copy())
                   for n, a in grads.items()}, state)


# -- the ring against JAX ------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_ring_equals_jax_at_one_rank(group, case):
    cfg, flags = CASES[case]
    grads = make_grads(1)
    rings, steps, _ = run_port(cfg, grads, flags, group)
    jrings, jsteps = run_jax(cfg, grads, flags)
    assert_ring_equal(rings, steps, jrings[0], jsteps[0])
    fb = rings[:STEPS, FIELDS.index(("fallback", "max"))]
    assert list(fb) == [float(s in flags) for s in range(STEPS)]


def test_escape_window_flips_to_the_escape_price(group):
    """The window's rows carry the escape's all-reduce price and no
    compression error; at one rank the received bytes are 0 either way,
    so the plan's prices are held directly."""
    cfg, flags = CASES["escape_window"]
    grads = make_grads(1)
    rings, _, _ = run_port(cfg, grads, flags, group)
    tx = grace_from_params(cfg, group=group).transform(seed=1)
    names = leaf_order(SHAPES)
    leaves = [torch.zeros(SHAPES[n]) for n in names]
    dense, link, esc, _ = tx._wire_plan(names, leaves, 4)
    from grace_tpu.comm import Allreduce as JaxAllreduce
    assert esc.total == JaxAllreduce().recv_wire_bytes(
        sum(2 * int(np.prod(SHAPES[n])) for n in names),
        sum(int(np.prod(SHAPES[n])) for n in names), 4)
    assert link.total != esc.total and dense == 4 * sum(
        int(np.prod(SHAPES[n])) for n in names)
    err = rings[:STEPS, FIELDS.index(("compression_error", "mean"))]
    assert [e == 0 for e in err] == [s in flags for s in range(STEPS)]


def _worker(rank, init_file, grads_path, out_paths):
    from grace_tpu_torch.parallel import init_process_group

    group, _ = init_process_group("cpu", rank=rank, world_size=WORLD,
                                  init_method=f"file://{init_file}")
    try:
        with np.load(grads_path) as data:
            grads = {n: data[n] for n in data.files}
        out = {}
        for label, (cfg, flags) in CASES.items():
            rings, steps, state = run_port(cfg, grads, flags, group, rank)
            out[f"{label}/rings"], out[f"{label}/steps"] = rings, steps
            records = TelemetryReader(every=STEPS).flush(state)
            out[f"{label}/records"] = np.frombuffer(
                json.dumps(records).encode(), dtype=np.uint8)
        np.savez(out_paths[rank], **out)
    finally:
        torch.distributed.destroy_process_group()


def test_rings_and_reader_equal_jax_at_four_ranks(tmp_path):
    grads = make_grads(WORLD, seed=3)
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
            pytest.fail(f"four-rank gloo run did not finish in {TIMEOUT_S} s")
    port = []
    for o in outs:
        with np.load(o) as data:
            port.append({k: data[k] for k in data.files})
    for label, (cfg, flags) in CASES.items():
        jrings, jsteps = run_jax(cfg, grads, flags, world=WORLD)
        for r in range(WORLD):
            assert_ring_equal(port[r][f"{label}/rings"],
                              port[r][f"{label}/steps"], jrings[r], jsteps[r],
                              label, WORLD)
        want = JaxReader(every=STEPS).flush(JaxTelemetryState(
            rings=jnp.asarray(jrings), steps=jnp.asarray(jsteps)))
        for r in range(WORLD):
            got = json.loads(port[r][f"{label}/records"].tobytes())
            assert [g["step"] for g in got] == [w["step"] for w in want]
            for g, w in zip(got, want):
                for name, _ in FIELDS:
                    tol = 0 if name in EXACT else norm_rtol(name, label,
                                                             WORLD)
                    np.testing.assert_allclose(g[name], w[name], rtol=tol,
                                               atol=0 if tol == 0 else 1e-7,
                                               err_msg=f"{label} {name}")
        # The allgather prices every other rank's payload: not zero here.
        assert port[0][f"{label}/rings"][0, FIELDS.index(
            ("wire_bytes", "first"))] > 0


# -- the reader ----------------------------------------------------------------

def _ring_run(group, capacity, steps, reader=None, every=None):
    cfg = {**TOPK, "telemetry": {"capacity": capacity}}
    tx = grace_from_params(cfg, group=group).transform(seed=1)
    rng = np.random.default_rng(5)
    state = tx.init({n: torch.zeros(s) for n, s in SHAPES.items()})
    records = []
    for i in range(steps):
        _, state = tx.update({n: torch.from_numpy(
            rng.standard_normal(s).astype(np.float32))
            for n, s in SHAPES.items()}, state)
        if reader is not None:
            records += reader.update(i, state)
    return state, records


def test_flush_is_one_transfer_per_window(group, monkeypatch):
    calls = [0]
    cpu = torch.Tensor.cpu

    def counting(self, *a, **k):
        calls[0] += 1
        return cpu(self, *a, **k)

    reader = TelemetryReader(every=5)
    flush, per_flush = reader.flush, []

    def counted_flush(state):
        before = calls[0]
        out = flush(state)
        per_flush.append(calls[0] - before)
        return out

    reader.flush = counted_flush
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    _, records = _ring_run(group, 16, 10, reader)
    assert reader.flushes == 2 and per_flush == [1, 1]
    assert [r["step"] for r in records] == list(range(10))


def test_ring_wraparound_is_counted_not_silent(group):
    reader = TelemetryReader(every=10)
    _, records = _ring_run(group, 4, 10, reader)
    assert [r["step"] for r in records] == [6, 7, 8, 9]
    assert reader.dropped == 6 and records[-1]["dropped_steps"] == 6


def test_flush_windows_are_contiguous_and_exact(group):
    reader = TelemetryReader(every=3)
    state, records = _ring_run(group, 8, 7, reader)
    records += reader.flush(state)
    assert [r["step"] for r in records] == list(range(7))
    assert reader.dropped == 0 and reader.flush(state) == []


# -- the sinks -----------------------------------------------------------------

RECORDS = [{"step": 0, "grad_norm": 1.5, "wire_bytes": 1024.0,
            "fallback": False, "note": "text"},
           {"step": 1, "grad_norm": 0.25, "wire_bytes": 2048},
           {"grad_norm": np.float32(3.0)}]


def test_tensorboard_sink_writes_jax_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1760000000.25)
    for sink_cls, name in ((TensorBoardSink, "port"),
                           (jax_sinks.TensorBoardSink, "jax")):
        with sink_cls(tmp_path / name) as sink:
            for rec in RECORDS:
                sink.write(rec)
    port = list((tmp_path / "port").iterdir())
    jaxf = list((tmp_path / "jax").iterdir())
    assert len(port) == len(jaxf) == 1 and port[0].name == jaxf[0].name
    data = port[0].read_bytes()
    assert data == jaxf[0].read_bytes() and len(data) > 100
    # TFRecord framing: length, masked CRC of the length, event, CRC.
    import struct
    n = struct.unpack("<Q", data[:8])[0]
    assert struct.unpack("<I", data[8:12])[0] == jax_sinks.masked_crc(
        data[:8])
    assert struct.unpack("<I", data[12 + n:16 + n])[0] == \
        jax_sinks.masked_crc(data[12:12 + n])


def test_jsonl_sink_header_once_and_multisink(tmp_path):
    path = tmp_path / "run.jsonl"
    sink = MultiSink(JSONLSink(path, provenance=run_provenance(
        "synthetic", tool="test")), TensorBoardSink(tmp_path / "tb"))
    sink.write({"step": 0, "x": 1.0})
    sink.write({"step": 1, "x": 2.0})
    sink.close()
    lines = [json.loads(l) for l in path.read_text().splitlines()]
    assert "provenance" in lines[0] and lines[0]["provenance"]["platform"] \
        == "cpu"
    assert [l.get("step") for l in lines[1:]] == [0, 1]
    with JSONLSink(path, provenance={"again": 1}) as again:
        again.write({"step": 2})
    assert sum("provenance" in json.loads(l)
               for l in path.read_text().splitlines()) == 1
    with pytest.raises(ValueError, match="closed"):
        again.write({"step": 3})


def test_telemetry_report_renders_the_port_jsonl(group, tmp_path):
    path = tmp_path / "run.jsonl"
    reader = TelemetryReader(JSONLSink(path, provenance=run_provenance(
        "synthetic")), every=4)
    _ring_run(group, 8, 8, reader)
    reader.close()
    tool = Path(__file__).resolve().parents[1] / "tools" / \
        "telemetry_report.py"
    out = subprocess.run([sys.executable, str(tool), str(path), "--json"],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    assert doc["provenance"]["data"] == "synthetic"
    assert "grad_norm" in json.dumps(doc)


def test_guard_monitor_transition_edges():
    lines, events = [], []

    class Sink:
        def write(self, rec):
            events.append(rec)

    mon = GuardMonitor(printer=lines.append, sink=Sink())
    base = {"notfinite_count": 0, "consecutive": 0, "fallback_remaining": 0,
            "fallback_active": False, "last_bad_step": -1}
    mon.update(0, base)
    mon.update(1, {**base, "notfinite_count": 1, "consecutive": 1})
    mon.update(2, {**base, "notfinite_count": 2, "fallback_remaining": 3,
                   "fallback_active": True})
    mon.update(3, {**base, "notfinite_count": 2, "fallback_remaining": 2,
                   "fallback_active": True})
    mon.update(4, {**base, "notfinite_count": 2})
    mon.update(5, {})
    assert [e["event"] for e in events] == [
        "guard_skip", "guard_skip", "guard_fallback_engaged",
        "guard_rearmed"]
    assert [e["step"] for e in events] == [1, 2, 2, 4]
    assert len(lines) == 4 and "re-armed" in lines[-1]


def test_ring_state_is_functional(group):
    """``telemetry_record`` leaves the old ring as it was (the guard's
    rollback selects it on a bad step)."""
    from grace_tpu_torch.telemetry import telemetry_init, telemetry_record
    ring = telemetry_init(TelemetryConfig(capacity=2))
    new = telemetry_record(ring, 3, {name: float(i)
                                     for i, (name, _) in enumerate(FIELDS)})
    assert isinstance(new, TelemetryState)
    assert ring.steps.tolist() == [-1, -1] and new.steps.tolist() == [-1, 3]
    assert new.rings[1].tolist() == [float(i) for i in range(len(FIELDS))]
    assert not ring.rings.any()
