"""The harness finds everything by name, the manifest keeps to the
benchmark's contract, and the trace reduction and metric readers read
what they say."""

import json
import re
import shutil
import subprocess
import sys
import time

import pytest

from portbench.harness import launch, manifest, trace, worker

M = manifest.load_json(manifest.MANIFEST)
CELLS = [w["name"] for w in M["workloads"]]
METRICS = M["end_to_end"] + M["per_layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = manifest.resolve(cell, M)
    assert c.family().build and c.family().loss
    assert c.reference_model().param_shapes(c.config)
    assert c.reference_codec().Codec
    assert c.counts().step_flops(c.config, 1) > 0
    for m in c.end_to_end + c.per_layer:
        assert callable(c.metric_reader(m["name"]).read)
    assert set(c.limits["limits"]) >= {"loss_gap", "update_gap"}
    assert any(v is not None for v in c.limits["limits"].values())


def test_a_mix_added_to_a_copy_is_found_without_code(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(manifest.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((bench / "mixes" / "topk1pct.json").read_text())
    mix["grace"]["compress_ratio"] = 0.05
    (bench / "mixes" / "topk5pct.json").write_text(json.dumps(mix))
    (bench / "limits" / "resnet50_topk5pct.json").write_text(
        json.dumps({"limits": {"update_median_gap": 0.1}}))
    m = json.loads(json.dumps(M))
    m["workloads"].append({"name": "resnet50_topk5pct", "config": "resnet50",
                           "traffic": "topk5pct", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    for c in m["configs"]:
        dst = tmp_path / c["file"]
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(manifest.ROOT / c["file"], dst)
    cell = manifest.resolve("resnet50_topk5pct", bench_dir=bench)
    assert cell.mix["grace"]["compress_ratio"] == 0.05
    assert cell.family().__file__.startswith(str(bench))


def test_manifest_keeps_to_the_contract():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "portbench/run.py"]
    assert M["paths"] == ["portbench"]
    assert 1 <= M["run_seconds"] <= 51
    assert 1 <= len(M["end_to_end"]) <= 16 and 1 <= len(M["per_layer"]) <= 128
    assert "setup_s" in {m["name"] for m in M["end_to_end"]}
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert "bound" not in m and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    assert all(w["chips"] in (1, 4) for w in M["workloads"])
    assert len(json.dumps(M)) < 64 * 1024


def test_names_units_and_lines_use_allowed_characters():
    names = ([m["name"] for m in METRICS] + CELLS
             + [c["name"] for c in M["configs"]]
             + [w["config"] for w in M["workloads"]]
             + [w["traffic"] for w in M["workloads"]]
             + [k for c in M["configs"] for k in c["reduced"]])
    for name in names:
        assert manifest.NAME_RE.match(name), name
    for m in METRICS:
        assert manifest.UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    texts = ([w["why"] for w in M["workloads"]] + [c["why"] for c in
             M["configs"]] + [c["source"] for c in M["configs"]]
             + [m["layer"] for m in M["per_layer"]] + M["command"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
    for c in M["configs"]:
        assert len(c["reduced"]) <= 16
        assert not any(re.search(
            r"(_dim|_rank|hidden_size|intermediate_size|latent|state_size|"
            r"projection|head_size|head_dim|expansion|experts_per_tok)", k)
            for k in c["reduced"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_per_layer_metric_moves_an_end_to_end_metric_of_its_cell(cell):
    c = manifest.resolve(cell, M)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


def test_metric_workloads_name_cells_that_report_what_it_moves():
    for m in METRICS:
        for cell in m.get("workloads", []):
            assert cell in CELLS, (m["name"], cell)
            e2e = manifest.resolve(cell, M).end_to_end
            assert m.get("moves", m["name"]) in {e["name"] for e in e2e}


def test_layers_are_named_alike():
    layers = {m["layer"] for m in M["per_layer"]}
    assert all(len(l.split("\n")) == 1 for l in layers)
    mfu = [m for m in M["per_layer"] if "mfu" in m["name"]]
    assert mfu and all(m["moves"] == "train_samples_per_s" for m in mfu)


# -- the trace reduction and the readers ---------------------------------------

def _x(name, cat, ts, dur, tid=1, pid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": pid, "args": args}


def synthetic_trace(path):
    """One profiled step: a forward-backward range launching two kernels
    (one from another thread), an optimizer range launching the two chunk
    kernels and an NCCL copy; a gap inside the optimizer range."""
    ev = [
        _x(trace.WINDOW_RANGE, "user_annotation", 0, 1000),
        _x("grace/forward_backward", "user_annotation", 10, 400),
        _x("cudaLaunchKernel", "cuda_runtime", 20, 5, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 300, 5, tid=7, correlation=2),
        _x("grace/optimizer", "user_annotation", 420, 320),
        _x("nccl:_all_gather_base", "user_annotation", 430, 20),
        _x("cudaMemcpyAsync", "cuda_runtime", 440, 5, correlation=3),
        _x("cudaLaunchKernel", "cuda_runtime", 460, 5, correlation=4),
        _x("cudaLaunchKernel", "cuda_runtime", 470, 5, correlation=5),
        _x("aten::add", "cpu_op", 745, 60),
        _x("gemm", "kernel", 30, 300, pid=0, tid=7, correlation=1),
        _x("bn", "kernel", 320, 100, pid=0, tid=7, correlation=2),
        _x("Memcpy DtoD", "gpu_memcpy", 450, 10, pid=0, correlation=3),
        _x("void chunk_compress_feedback_kernel<false>(T)", "kernel", 500,
           100, pid=0, correlation=4),
        _x("void chunk_aggregate_dense_kernel<false>(T)", "kernel", 700, 50,
           pid=0, correlation=5),
        _x("late", "kernel", 1500, 10, pid=0, correlation=9),
    ]
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.load(path, steps=1)


def test_trace_reduction(tmp_path):
    t = synthetic_trace(tmp_path / "t.json")
    assert len(t.device_ops) == 5                  # "late" is outside
    assert sum(o.dur for o in t.launched_in("grace/forward_backward")) == 400
    assert sum(o.dur for o in t.launched_in("grace/optimizer")) == 160
    assert sum(o.dur for o in t.launched_in("nccl:", prefix=True)) == 10
    assert t.busy_us() == 550          # 30-420, 450-460, 500-600, 700-750
    gaps = t.idle_gaps()
    assert gaps[0] == (0, 30) and gaps[-1] == (750, 1000)
    b = trace.breakdown(t)
    assert b["device_ops"][0] == ["gemm", 300e-6]
    names = dict(b["idle_gaps"])
    assert names == pytest.approx({"host: aten::add": 250e-6,
                                   "grace/optimizer": 170e-6,
                                   "idle": 30e-6})


def test_readers_on_a_synthetic_run(tmp_path):
    cell = manifest.resolve("resnet50_topk1pct", M)
    t = synthetic_trace(tmp_path / "t.json")
    sizes = [8000, 20000]
    rec = worker.RunRecord(cell, world=1, batch=4, steps=10, window_s=2.0,
                           setup_s=3.0, window_peak_bytes=2 ** 31,
                           leaf_sizes=sizes, trace=t, lead_steps=5,
                           lead_s=0.5)

    def read(name):
        return cell.metric_reader(name).read(rec)

    assert read("train_samples_per_s") == 20.0
    assert read("peak_mem_gib") == 2.0 and read("setup_s") == 3.0
    assert read("fwd_bwd_device_ms") == pytest.approx(0.4)
    assert read("update_device_ms") == pytest.approx(0.16)
    assert read("update_host_ms") == pytest.approx(0.32)
    assert read("collective_device_ms") == pytest.approx(0.01)
    assert read("device_idle_share") == pytest.approx(45.0)
    bound = (12 * 28000 + 8 * 280) / 3.35e12
    assert read("chunk_compress_feedback_roofline") == pytest.approx(
        100 * bound / 100e-6)
    flops = cell.counts().step_flops(cell.config, 4)
    assert read("step_mfu") == pytest.approx(100 * flops / 0.1 / 989e12)


def test_reader_finds_nothing_where_the_trace_has_nothing(tmp_path):
    cell = manifest.resolve("resnet50_topk1pct", M)
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": [
        _x(trace.WINDOW_RANGE, "user_annotation", 0, 100)]}))
    rec = worker.RunRecord(cell, 1, 4, 1, 1.0, 1.0, 0, [10],
                           trace.load(p, 1))
    for name in ("chunk_compress_feedback_roofline",
                 "chunk_aggregate_dense_roofline", "collective_device_ms",
                 "fwd_bwd_device_ms", "step_mfu"):
        assert cell.metric_reader(name).read(rec) is None


# -- the card ------------------------------------------------------------------

@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the run measures the card")


def test_run_without_a_card_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(manifest.BENCH_DIR / "run.py"),
                          "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_one_cell_runs_correct_on_the_card(card):
    out = subprocess.run([sys.executable, str(manifest.BENCH_DIR / "run.py"),
                          "--workload", "resnet50_topk1pct",
                          "--seed", str(2 ** 31 + 99), "--seconds", "3",
                          "--trace", "1"],
                         capture_output=True, text=True, timeout=600,
                         cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert 0 < line["metrics"]["chunk_compress_feedback_roofline"]["value"] \
        <= 105
    assert out.stderr.strip().splitlines()[-1].startswith("check correct")


@pytest.mark.card
@pytest.mark.parametrize("cell", ["resnet50_topk1pct", "bert_base_topk1pct"])
def test_control_run_is_incorrect_on_the_card(card, cell):
    """The reference in float8 in the program's place, at the cell's own
    size, judged by the cell's own limits."""
    out = launch.execute({"workload": cell, "seed": 2 ** 31 + 101,
                          "seconds": 1, "trace": False, "device": "cuda",
                          "t0": time.time(), "fault": worker.CONTROL}, 1)
    assert out["line"]["correct"] is False, out["checks"]
