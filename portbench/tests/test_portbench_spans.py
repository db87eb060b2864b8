"""The reader of the program's own ``grace/apply_updates`` ranges,
``apply_device_ms``; a traced run of the four-rank cell on two gloo
ranks; on the card, the span log is causal on its one clock."""

import json

import pytest
import torch

from portbench.harness import launch, manifest, trace, worker
from portbench.tests.test_portbench_harness import _x, synthetic_trace
from portbench.tests.tiny import spec, tiny_manifest

M = manifest.load_json(manifest.MANIFEST)


def _record(cell, t):
    return worker.RunRecord(cell, world=1, batch=4, steps=10, window_s=2.0,
                            setup_s=3.0, window_peak_bytes=0,
                            leaf_sizes=[8000], trace=t)


def test_apply_device_ms_reads_the_apply_ranges(tmp_path):
    cell = manifest.resolve("resnet50_topk1pct", M)
    ev = json.loads(json.dumps({"traceEvents": [
        _x(trace.WINDOW_RANGE, "user_annotation", 0, 1000),
        _x("grace/optimizer", "user_annotation", 10, 500),
        _x("grace/apply_updates", "user_annotation", 300, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 20, 5, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 310, 5, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 320, 5, correlation=3),
        _x("exchange", "kernel", 30, 200, pid=0, correlation=1),
        _x("sgd", "kernel", 330, 40, pid=0, correlation=2),
        _x("sgd", "kernel", 380, 60, pid=0, correlation=3)]}))
    p = tmp_path / "t.json"
    p.write_text(json.dumps(ev))
    rec = _record(cell, trace.load(p, steps=2))
    assert cell.metric_reader("apply_device_ms").read(rec) == \
        pytest.approx(0.05)
    assert cell.metric_reader("update_device_ms").read(rec) == \
        pytest.approx(0.15)
    rec = _record(cell, synthetic_trace(tmp_path / "s.json"))
    assert cell.metric_reader("apply_device_ms").read(rec) is None


def test_four_rank_cell_runs_traced_on_two_ranks(tmp_path):
    """The four-rank cell's traced run, on two gloo ranks: correct, its
    host-side readers report, and ``apply_device_ms`` finds no kernels
    off the card."""
    m = tiny_manifest(tmp_path, compute_dtype="float32")
    out = launch.execute(spec(m, "resnet50_topk1pct_w4", trace=True), 2,
                         timeout_s=600)
    line = out["line"]
    assert line["correct"] is True, out["checks"]
    got = line["metrics"]
    assert got["update_host_ms"]["value"] > 0
    assert "apply_device_ms" not in got


@pytest.mark.card
def test_span_log_is_causal_on_the_shared_clock(tmp_path):
    """A tiny ResNet-50 cell's steps on the card, logged: every span's
    device interval starts no earlier than its host start less the
    anchor's error, which is under 50 µs."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the span log's device times need one")
    from grace_tpu_torch.telemetry import spans

    m = tiny_manifest(tmp_path)
    cell = manifest.resolve("resnet50_topk1pct", m, limits={})
    group, device = worker._join({"rank": 0, "world": 1, "device": "cuda"})
    try:
        prog = worker.build_program(cell, 2 ** 31 + 5, device, group, None)
        for i in range(3):
            prog.state, _ = prog.step(prog.state, prog.batches[i % 4])
        spans.arm(5, device)
        for i in range(5):
            prog.state, _ = prog.step(prog.state, prog.batches[i % 4])
        log = spans.collect()
        spans.disarm()
    finally:
        torch.distributed.destroy_process_group()
    assert log.steps == 5 and log.dropped == 0
    assert log.anchor_error_ns is not None and log.anchor_error_ns < 50_000
    for s in log.spans:
        assert s.device_start_ns >= s.host_start_ns - log.anchor_error_ns, s
        assert s.device_end_ns >= s.device_start_ns
    assert spans.host_lead_ms(log) is not None
