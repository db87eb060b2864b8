"""The port's profiler read side against the JAX package's, on the CPU.

* The analyzer: ``tests/test_profiling.py``'s canned Chrome trace
  (``tests/data/perf_trace.json.gz``) and its constructed span sets
  (overlap disjoint, hidden, partial, absent, fragmented; self-time
  nesting; the unattributed bucket) go through both packages' analyzers
  and give equal ``as_dict()`` and ``render()``, with JAX's exact numbers.
* A ``torch.profiler`` capture of a two-rank gloo step of the port
  (``utils.profiling.trace``): the stage table comes from the ``grace/...``
  ranges, the collectives inside them are wire time, the stages sum to the
  total; the two ranks' captures merge and round-trip.
* The export: ``chrome_trace_doc`` gives JAX's document byte for byte on
  JAX's spans, ``write_chrome_trace`` round-trips, ``merge_host_traces``
  equals JAX's.
* ``StepTimer`` (``tests/test_profiling.py:323-380``) on the same
  durations: the warn-once on an unsynchronised step, no warning when
  synced, the row kept on a ``BaseException``, the percentiles.
* ``ProfileRecorder``: the windowed records and their caveats, the kernel
  builds counted as ``perf_compile``/``perf_retrace``, the memory
  watermarks under JAX's keys, the footprint record.

Not ported, and so not held here: the JAX tests of the XPlane half
(``test_xplane_roundtrip``, ``test_hlo_scope_map_harvests_nearest_named_
ancestor``, ``test_enrich_spans_overrides_stage_free_scope``), which
decode XLA's XSpace protobuf and its HLO metadata; ``torch.profiler``
writes neither (its Chrome trace carries the ranges and the launch
correlation that attribute kernels instead), and the port's loader refuses
an ``.xplane.pb``. The weak-type retrace tests need a jit cache, which the
port's eager steps do not have; the port counts kernel builds in its place.
"""

import functools
import json
import os
import time
import warnings

import pytest
import torch
import torch.multiprocessing as mp

from grace_tpu_torch.profiling import (ProfileRecorder, Span, analyze_spans,
                                       analyze_trace, chrome_trace_doc,
                                       compile_count,
                                       device_memory_watermarks,
                                       find_latest_trace, interval_union_us,
                                       load_trace_events, merge_host_traces,
                                       overlap_us, parse_chrome_trace,
                                       write_chrome_trace)
from grace_tpu_torch.profiling.trace_analysis import UNATTRIBUTED
from grace_tpu_torch.telemetry.scopes import STAGE_STEP
from grace_tpu_torch.utils.profiling import StepTimer

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURE = os.path.join(DATA, "perf_trace.json.gz")
TIMEOUT_S = 120


def _jax_span(**kw):
    from grace_tpu.profiling import Span as JaxSpan
    return JaxSpan(**kw)


# -- the canned trace ----------------------------------------------------------------

def test_fixture_as_dict_and_render_equal_jax():
    from grace_tpu.profiling import analyze_trace as jax_analyze

    mine, ref = analyze_trace(FIXTURE), jax_analyze(FIXTURE)
    assert mine.as_dict() == ref.as_dict()
    assert mine.render() == ref.render()


def test_fixture_exact_stage_attribution():
    a = analyze_trace(FIXTURE)
    assert a.devices == ["/device:TPU:0", "/device:TPU:1"]
    assert a.device_lanes_detected
    stages_ms = {k: round(v * 1e-3, 6) for k, v in a.stage_us.items()}
    assert stages_ms == {"grace/forward_backward": 3.2,
                         "grace/exchange": 1.6,
                         "grace/compress": 1.2,
                         "grace/decompress": 0.8,
                         "grace/optimizer": 0.8}
    assert abs(sum(a.stage_us.values()) - a.total_us) < 1e-9
    assert round(a.total_us * 1e-3, 6) == 7.6


def test_fixture_overlap_split_and_steps():
    a = analyze_trace(FIXTURE)
    assert round(a.collective_us * 1e-3, 6) == 1.6
    assert round(a.compute_us * 1e-3, 6) == 6.0
    assert a.overlap_fraction == pytest.approx(0.25, abs=1e-9)
    sp = a.step_percentiles_ms()
    assert sp["n"] == 8 and sp["p50_ms"] == pytest.approx(0.9)
    assert sp["max_ms"] == pytest.approx(0.9)


def test_analyze_trace_takes_a_directory(tmp_path):
    import shutil
    run = tmp_path / "plugins" / "profile" / "run"
    run.mkdir(parents=True)
    shutil.copy(FIXTURE, run / "host.trace.json.gz")
    assert find_latest_trace(str(tmp_path)) == str(run / "host.trace.json.gz")
    assert analyze_trace(str(tmp_path)).total_us == pytest.approx(7600.0)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        analyze_trace(str(empty))


def test_xplane_is_not_read(tmp_path):
    path = tmp_path / "host.xplane.pb"
    path.write_bytes(b"\x0a\x00")
    with pytest.raises(ValueError, match="XSpace"):
        load_trace_events(str(path))


# -- constructed span sets (tests/test_profiling.py:116-178) --------------------------

def _dev(comp, coll):
    """Compute spans on lane 'a', collective spans on lane 'b', one TPU."""
    spans = [dict(name="fusion.1", ts=s, dur=e - s, device="/device:TPU:0",
                  lane="a") for s, e in comp]
    spans += [dict(name="all-reduce.1", ts=s, dur=e - s,
                   device="/device:TPU:0", lane="b") for s, e in coll]
    return spans


CASES = {
    "disjoint": (_dev([(0, 100)], [(100, 200)]), {"overlap_fraction": 0.0}),
    "hidden": (_dev([(0, 200)], [(50, 150)]), {"overlap_fraction": 1.0}),
    "partial": (_dev([(0, 100)], [(50, 150)]), {"overlap_fraction": 0.5}),
    "no_collective": (_dev([(0, 100)], []), {"overlap_fraction": None}),
    "fragments": (_dev([(0, 300)], [(0, 100), (50, 150)]),
                  {"overlap_fraction": 1.0, "collective_ms": 0.15}),
    "nesting": ([dict(name="grace/compress/outer.1", ts=0, dur=100,
                      device="/device:TPU:0", lane="a"),
                 dict(name="grace/decompress/inner.2", ts=10, dur=30,
                      device="/device:TPU:0", lane="a")],
                {"stages_ms": {"grace/compress": 0.07,
                               "grace/decompress": 0.03},
                 "total_device_ms": 0.1}),
    "unattributed": (_dev([(0, 100)], []) + [
        dict(name="grace/compress/x.1", ts=200, dur=50,
             device="/device:TPU:0", lane="a")],
        {"stages_ms": {UNATTRIBUTED: 0.1, "grace/compress": 0.05}}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_constructed_spans_equal_jax(case):
    from grace_tpu.profiling import analyze_spans as jax_analyze

    spans, want = CASES[case]
    mine = analyze_spans([Span(**kw) for kw in spans]).as_dict()
    ref = jax_analyze([_jax_span(**kw) for kw in spans]).as_dict()
    assert mine == ref
    for k, v in want.items():
        assert mine[k] == (pytest.approx(v) if isinstance(v, float) else v)
    assert abs(sum(mine["stages_ms"].values())
               - mine["total_device_ms"]) < 1e-9


def test_interval_primitives():
    assert interval_union_us([(0, 10), (5, 20), (30, 40)]) == \
        [(0, 20), (30, 40)]
    assert overlap_us([(0, 20), (30, 40)], [(10, 35)]) == 15.0


# -- a CUDA capture's layout, as torch.profiler writes it on the card ------------

def _cuda_doc():
    """Kineto's layout: the kernels on a "stream 7 " thread of the
    process, each with the correlation id of its launch; the backward's
    launch on autograd's thread; the ranges projected onto the stream as
    gpu_user_annotation; the session's own "Trace" span."""
    def x(cat, name, tid, ts, dur, corr=None):
        ev = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
              "ts": ts, "dur": dur}
        if corr is not None:
            ev["args"] = {"correlation": corr, "External id": corr + 100}
        return ev

    meta = [{"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
             "args": {"name": "python3"}}]
    meta += [{"ph": "M", "name": "thread_name", "pid": 1, "tid": t,
              "args": {"name": n}} for t, n in (
                  (10, "thread 10 (python3)"), (11, "thread 11 (python3)"),
                  (7, "stream 7 "))]
    return {"traceEvents": meta + [
        x("user_annotation", "grace/forward_backward", 10, 0, 100),
        x("user_annotation", "grace/optimizer", 10, 100, 50),
        x("user_annotation", "grace/compress", 10, 110, 10),
        x("cuda_runtime", "cudaLaunchKernel", 10, 5, 2, corr=1),
        x("cuda_runtime", "cudaLaunchKernel", 11, 50, 2, corr=2),
        x("cuda_runtime", "cudaLaunchKernel", 10, 112, 2, corr=3),
        x("cuda_runtime", "cudaLaunchKernel", 10, 160, 2, corr=4),
        x("kernel", "fwd_gemm", 7, 20, 30, corr=1),
        x("kernel", "bwd_gemm", 7, 60, 40, corr=2),
        x("kernel", "chunk_compress_feedback_grouped_kernel", 7, 115, 10,
          corr=3),
        x("kernel", "ncclDevKernel_AllGather_RING_LL", 7, 170, 5, corr=4),
        x("gpu_user_annotation", "grace/forward_backward", 7, 20, 80),
        x("gpu_user_annotation", "Optimizer.step#SGD.step", 7, 115, 10),
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
         "pid": "Spans", "tid": "PyTorch Profiler", "ts": 0, "dur": 200}]}


def test_cuda_capture_kernels_follow_their_launch():
    """A kernel takes the grace/ range around its launch, on the launching
    thread or, for autograd's thread, the process's open range; the ranges
    on the stream and the session span are no device work."""
    spans = parse_chrome_trace(_cuda_doc())
    by_name = {s.name: s for s in spans if s.cat == "kernel"}
    assert by_name["fwd_gemm"].stage() == "grace/forward_backward"
    assert by_name["bwd_gemm"].stage() == "grace/forward_backward"
    assert by_name["chunk_compress_feedback_grouped_kernel"].stage() == \
        "grace/compress"
    assert by_name["ncclDevKernel_AllGather_RING_LL"].stage() == ""
    a = analyze_spans(spans)
    assert a.device_lanes_detected and a.devices == ["python3"]
    assert a.stage_us == {"grace/forward_backward": 70.0,
                          "grace/compress": 10.0, UNATTRIBUTED: 5.0}
    assert a.total_us == 85.0                 # the four kernels' durations
    assert a.collective_us == 5.0 and a.overlap_fraction == 0.0
    assert a.step_times_us == []


# -- a torch.profiler capture of a two-rank port step --------------------------------

def _capture_worker(rank, init_file, logdir):
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.parallel import init_process_group
    from grace_tpu_torch.train import init_train_state, make_train_step
    from grace_tpu_torch.utils.profiling import trace

    group, _ = init_process_group("cpu", rank=rank, world_size=2,
                                  init_method=f"file://{init_file}")
    torch.set_num_threads(1)
    try:
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(16, 32),
                                    torch.nn.ReLU(), torch.nn.Linear(32, 4))
        grc = grace_from_params({"compressor": "topk",
                                 "compress_ratio": 0.1,
                                 "topk_algorithm": "chunk",
                                 "memory": "residual",
                                 "communicator": "allgather"}, group=group)
        tx = grc.transform(0)
        state = init_train_state(
            model, tx, torch.optim.SGD(model.parameters(), lr=0.1), group)
        step = make_train_step(
            lambda m, b: torch.nn.functional.cross_entropy(m(b[0]), b[1]),
            tx, group)
        gen = torch.Generator().manual_seed(rank)
        batch = (torch.randn(8, 16, generator=gen),
                 torch.randint(0, 4, (8,), generator=gen))
        state, _ = step(state, batch)
        with trace(os.path.join(logdir, f"rank{rank}"), device="cpu"):
            for _ in range(2):
                state, _ = step(state, batch)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("capture")
    ctx = mp.start_processes(
        _capture_worker, args=(str(tmp / "store"), str(tmp)), nprocs=2,
        join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"two-rank capture did not finish in {TIMEOUT_S} s")
    return [str(tmp / f"rank{r}") for r in range(2)]


def test_torch_capture_attributes_the_grace_ranges(captures):
    for logdir in captures:
        path = find_latest_trace(logdir)
        assert path.endswith(".pt.trace.json.gz")
        a = analyze_trace(logdir)
        assert not a.device_lanes_detected          # a CPU capture
        stages = set(a.stage_us)
        assert {"grace/forward_backward", "grace/optimizer",
                "grace/compress", "grace/exchange",
                "grace/decompress"} <= stages
        assert abs(sum(a.stage_us.values()) - a.total_us) < 1e-6
        # Every forward and backward op of both steps sits inside its
        # range, and nearly all of the step's ops are attributed to a stage
        # below the step's root: an op in grace/step alone, or outside every
        # range, is unattributed (none on this model). Counted in ops,
        # not microseconds: the unattributed time is mostly gloo's
        # worker-thread ranges, whose length is the wait for the other rank
        # and grows with host load.
        spans = load_trace_events(path)
        ops = [s for s in spans if s.cat != "Trace" and not s.is_range()
               and not s.is_step_marker()]
        fwd = [s for s in ops if s.name in ("aten::linear", "aten::relu",
                                            "aten::cross_entropy_loss")]
        bwd = [s for s in ops if "Backward0" in s.name]
        assert len(fwd) == 2 * 4 and len(bwd) >= 2 * 5
        assert {s.stage() for s in fwd} == {"grace/forward"}
        assert {s.stage() for s in bwd} == {"grace/backward"}
        assert sum(1 for s in ops if s.stage() in ("", STAGE_STEP)) < \
            0.05 * len(ops)
        assert a.collective_us > 0.0                # gloo's all-gathers
        gathers = [s for s in spans if "allgather" in s.name.lower()
                   and s.stage()]
        assert gathers and {s.stage() for s in gathers} == \
            {"grace/exchange"}


def test_torch_captures_merge_and_round_trip(captures, tmp_path):
    per_host = {f"rank{r}": load_trace_events(find_latest_trace(d))
                for r, d in enumerate(captures)}
    merged = merge_host_traces(per_host)
    assert len(merged) == sum(len(v) for v in per_host.values())
    assert {s.device.split("/")[0] for s in merged} == {"rank0", "rank1"}
    path = write_chrome_trace(merged, str(tmp_path / "merged.trace.json.gz"))
    back = load_trace_events(path)
    assert set(back) == set(merged)
    a = analyze_spans(back)
    assert {"grace/exchange", "grace/compress"} <= set(a.stage_us)


# -- the export (tests/test_evidence.py:254-305) ---------------------------------------

def _spans(make):
    return [
        make(name="allreduce-hop0", ts=0.0, dur=10.0,
             device="/device:TPU:0", lane="XLA Ops", scope="ici"),
        make(name="allreduce-hop1", ts=10.0, dur=12.0,
             device="/device:TPU:0", lane="XLA Ops", scope="dcn"),
        make(name="step", ts=0.0, dur=25.0,
             device="/device:TPU:0", lane="Steps", scope=""),
        make(name="allreduce-hop0", ts=1.0, dur=9.0,
             device="/device:TPU:1", lane="XLA Ops", scope="ici"),
    ]


@pytest.mark.parametrize("suffix", [".json", ".json.gz"])
def test_chrome_trace_round_trip(tmp_path, suffix):
    spans = _spans(Span)
    path = str(tmp_path / f"trace{suffix}")
    write_chrome_trace(spans, path)
    assert set(load_trace_events(path)) == set(spans)


def test_chrome_trace_doc_equals_jax():
    from grace_tpu.profiling.trace_export import \
        chrome_trace_doc as jax_doc

    mine = json.dumps(chrome_trace_doc(_spans(Span)))
    assert mine == json.dumps(jax_doc(_spans(_jax_span)))
    assert mine == json.dumps(chrome_trace_doc(list(reversed(_spans(Span)))))


def test_merge_host_traces_equals_jax():
    from grace_tpu.profiling.trace_export import \
        merge_host_traces as jax_merge

    def shifted(make):
        return [make(name=s.name, ts=s.ts + 1e6, dur=s.dur, device=s.device,
                     lane=s.lane, scope=s.scope) for s in _spans(make)]

    mine = merge_host_traces({"host0": _spans(Span), "host1": shifted(Span)})
    ref = jax_merge({"host0": _spans(_jax_span),
                     "host1": shifted(_jax_span)})
    key = [(s.name, s.ts, s.dur, s.device, s.lane, s.scope) for s in ref]
    assert [(s.name, s.ts, s.dur, s.device, s.lane, s.scope)
            for s in mine] == key
    assert min(s.ts for s in mine if s.device.startswith("host1/")) == 0.0
    assert set(parse_chrome_trace(chrome_trace_doc(mine))) == set(mine)


# -- StepTimer (tests/test_profiling.py:323-380) ----------------------------------------

def _timers():
    from grace_tpu.utils.profiling import StepTimer as JaxStepTimer
    return StepTimer, JaxStepTimer


def test_steptimer_warns_once_on_missing_sync():
    for cls in _timers():
        t = cls(warmup=0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(3):
                with t.step():
                    pass
        msgs = [w for w in caught if "sync_on" in str(w.message)]
        assert len(msgs) == 1, cls
        assert t.measured_async_dispatch and len(t) == 3


def test_steptimer_synced_steps_do_not_warn():
    import jax.numpy as jnp

    for cls, out in zip(_timers(), (torch.ones(4) * 2, jnp.ones((4,)) * 2)):
        t = cls(warmup=0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with t.step():
                t.sync_on(out)
        assert not [w for w in caught if "sync_on" in str(w.message)]
        assert not t.measured_async_dispatch


def test_steptimer_keeps_timing_row_on_exception():
    import jax.numpy as jnp

    for cls, out in zip(_timers(), (torch.ones(()), jnp.ones(()))):
        t = cls(warmup=0)
        with pytest.raises(KeyboardInterrupt):
            with t.step():
                raise KeyboardInterrupt
        assert len(t) == 1 and t.failed_steps == 1
        with t.step():
            t.sync_on(out)
        assert len(t) == 2 and t.failed_steps == 1


def test_steptimer_statistics_equal_jax():
    rows = [99.0, 1.0, 2.0, 3.0, 4.0]
    mine, ref = (cls(warmup=1) for cls in _timers())
    mine._times, ref._times = list(rows), list(rows)
    assert mine.p50_sec == ref.p50_sec == pytest.approx(2.5)
    assert mine.percentile_sec(100) == ref.percentile_sec(100) == 4.0
    assert mine.mean_sec == ref.mean_sec
    assert mine.throughput(32) == ref.throughput(32)
    assert mine.confidence95(32) == ref.confidence95(32)


# -- ProfileRecorder ------------------------------------------------------------------------

class ListSink:
    def __init__(self):
        self.records = []

    def write(self, rec):
        self.records.append(dict(rec))

    def close(self):
        pass


@pytest.mark.filterwarnings(
    "ignore:StepTimer.step\\(\\) completed without sync_on:RuntimeWarning")
def test_recorder_flush_records_percentiles_and_caveats():
    sink = ListSink()
    rec = ProfileRecorder(sink, every=2, warmup=0)
    for i in range(4):
        with rec.step():
            pass                              # no sync_on: launch-only
        rec.update(i)
    times = [r for r in sink.records if r["event"] == "perf_step_times"]
    assert len(times) == 2
    last = times[-1]
    assert last["n_steps"] == 4
    assert {"mean_ms", "p50_ms", "p90_ms", "p99_ms", "max_ms"} <= set(last)
    assert last["sync_missing"] is True
    assert last["retrace_check"].startswith("none: eager torch steps")
    assert not [r for r in sink.records if r["event"] == "perf_memory"]


def test_recorder_counts_kernel_builds(monkeypatch):
    from grace_tpu_torch.ops import _build

    @functools.cache
    def library(name):
        return name

    monkeypatch.setattr(_build, "library", library)
    base = compile_count()
    sink = ListSink()
    rec = ProfileRecorder(sink, every=100, warmup=0, step_fn=object())
    library("chunk_topk")                     # built before the run
    for i, built in enumerate([None, "quant", None, "wire"]):
        with rec.step():
            if built:
                library(built)                # built at its first launch
            rec.sync_on(torch.ones(()))
        rec.update(i)
    events = [(r["event"], r["step"], r["cache_size"]) for r in sink.records]
    assert events == [("perf_compile", 0, base + 1),
                      ("perf_retrace", 1, base + 2),
                      ("perf_retrace", 3, base + 3)]
    assert rec.retraces == 2


def test_memory_watermarks_under_jaxs_keys(monkeypatch):
    assert device_memory_watermarks() is None  # no CUDA here
    stats = {0: {"allocated_bytes.all.current": 100,
                 "allocated_bytes.all.peak": 300},
             1: {"allocated_bytes.all.current": 200,
                 "allocated_bytes.all.peak": 250}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: stats[d])
    assert device_memory_watermarks([0, 1]) == {
        "n_devices": 2, "bytes_in_use": 200, "peak_bytes_in_use": 300}


@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


def test_recorder_footprint_record_matches_the_model(group):
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.profiling import check_state_footprint

    grc = grace_from_params({"compressor": "topk", "compress_ratio": 0.25,
                             "memory": "residual",
                             "communicator": "allgather", "telemetry": 16},
                            group=group)
    params = {"w": torch.zeros(16, 4), "b": torch.zeros(4)}
    state = grc.transform(0).init(params)
    sink = ListSink()
    rec = ProfileRecorder(sink)
    got = rec.record_state_footprint(state, grc, params, world=8, step=3)
    assert got["footprint_matches"] is True and got["step"] == 3
    want = check_state_footprint(state, grc, params, world=8)
    assert got["mem_bytes"] == want["live"]["mem_bytes"] == \
        want["model"]["mem_bytes"]
    assert sink.records == [got]
