"""The port's read-side command lines against the repository's tools, on
the CPU, on the same input files.

Each tool is loaded by path, read-only (``tools/telemetry_report.py``,
``graft_watch.py``, ``perf_report.py``, ``graft_gate.py``,
``graft_lint.py``, ``evidence_summary.py``), and each port command line's
``main`` runs beside it:

* ``python -m grace_tpu_torch.telemetry`` against ``telemetry_report``
  on the JSONL artifacts of the JAX tools' own tests
  (``tests/test_telemetry.py``'s fallback run, ``tests/test_watch.py``'s
  watch section and drift artifacts, ``tests/test_profiling.py``'s
  ``perf_*`` records), on lint, adapt and retune events, and on a JSONL
  the port's own ``JSONLSink`` wrote in a 3-step CPU run with telemetry and
  the watch: the text line for line, the ``--json`` document equal, the
  exit codes equal (an empty file: 1).
* ``python -m grace_tpu_torch.telemetry.watch`` against ``graft_watch``:
  the timeline, the re-derived anomalies and the summary line for line,
  the document equal but for the fields :data:`WATCH_OWN` (the tool's
  name, the clock); the exit codes of the clean and the seeded-regression
  baselines.
* ``python -m grace_tpu_torch.profiling`` against ``perf_report`` on
  ``tests/data/perf_trace.json.gz``: text, document (but for
  :data:`PROF_OWN`), baselines and ``--overlap-config``'s sandwich.
* ``python -m grace_tpu_torch.evidence`` against ``graft_gate`` on a tree
  with claims and a ledger: text, ``--json``, ``--ci`` exit codes,
  ``--update-readme``'s README.
* ``python -m grace_tpu_torch.analysis --all-configs --evidence`` against
  ``graft_lint``'s ``LINT_LAST.json`` on a one-entry registry (but for
  :data:`LINT_OWN`); ``--list``, ``--rules-only``, ``--no-rules``, the
  ledger record.
* ``python -m grace_tpu_torch.evidence.summary``: the lint, profiling and
  region sections (and the rest) equal to ``evidence_summary``'s on the
  repository's committed documents, ``REGION_LAST.json`` among them (read,
  never written).
* Every new default output path lies under ``grace_tpu_torch/`` and is
  gitignored; ``--update-readme`` without ``--root`` is refused.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "perf_trace.json.gz")
# The document fields that name the writer or the clock, not the run.
CLOCK = ("captured_at", "git_rev")
WATCH_OWN = ("tool",) + CLOCK
PROF_OWN = ("tool",) + CLOCK
LINT_OWN = ("tool", "device", "shard") + CLOCK
# The JAX package's committed evidence documents the summary reads.
DOCS = ("LINT_LAST.json", "PROF_LAST.json", "ELASTIC_LAST.json",
        "REGION_LAST.json", "ADAPT_LAST.json", "RETUNE_LAST.json",
        "WATCH_LAST.json", "TUNE_LAST.json")


def _tool(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"{name}_vs_port", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _masked(doc, drop):
    return {k: v for k, v in doc.items() if k not in drop}


def _both(capsys, jax_main, port_main, argv):
    """``((rc, stdout) of the JAX tool, (rc, stdout) of the port)``."""
    capsys.readouterr()
    jax_rc = jax_main(list(argv))
    jax_out = capsys.readouterr().out
    port_rc = port_main(list(argv))
    port_out = capsys.readouterr().out
    return (jax_rc, jax_out), (port_rc, port_out)


# -- the artifacts ---------------------------------------------------------------

def _rows(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(path)


def _fallback_run(path):
    """tests/test_telemetry.py::test_telemetry_report_renders_summary."""
    rows = [{"provenance": {"data": "synthetic", "git_commit": "abc123"}}]
    for i in range(6):
        fb = 1.0 if i in (2, 3) else 0.0
        rows.append({"step": i, "grad_norm": 1.0 + i, "update_norm": 1.0,
                     "residual_norm": 0.1, "residual_max": 0.2,
                     "compression_error": 0.0 if fb else 0.4,
                     "wire_bytes": 168.0 if fb else 200.0,
                     "dense_bytes": 336.0, "fallback": fb})
    rows.append({"event": "guard_skip", "step": 2, "notfinite_count": 1})
    return _rows(path, rows)


def _watch_section(path):
    """tests/test_watch.py::test_telemetry_report_watch_section_and_json,
    with a per-link split and a consensus repair beside it."""
    rows = [{"provenance": {"data": "synthetic"}}]
    for s in range(6):
        rows.append({"step": s, "grad_norm": 1.0,
                     "wire_bytes": 184.0 if s % 5 == 0 else 100.0,
                     "wire_bytes_ici": 150.0, "wire_bytes_dcn": 34.0,
                     "dense_bytes": 336.0, "fallback": 0.0,
                     "watch_bytes": 84.0 if s % 5 == 0 else 0.0,
                     **({"dropped_steps": 2, "guard_notfinite_count": 1,
                         "guard_last_bad_step": 5} if s == 5 else {})})
    rows += [{"event": "watch", "step": 5, "grad_norm_mean": 1.0,
              "grad_norm_min": 0.9, "grad_norm_max": 1.1,
              "compression_error_mean": 0.4, "compression_error_min": 0.3,
              "compression_error_max": 0.6, "residual_norm_mean": 1.0,
              "residual_norm_min": 0.9, "residual_norm_max": 1.1,
              "skew_max": 0.42, "skew_rank": 6},
             {"event": "watch_anomaly", "step": 5, "kind": "skew",
              "metric": "compression_error", "rank": 6, "score": 9.5,
              "threshold": 6.0, "value": 0.2},
             {"event": "guard_skip", "step": 5, "notfinite_count": 1},
             {"event": "consensus_repair", "step": 5, "repairs": 1,
              "last_divergent_rank": 3}]
    return _rows(path, rows)


def _perf_records(path):
    """tests/test_profiling.py::test_telemetry_report_renders_perf_records,
    with lint, adapt and retune events beside them."""
    rows = [
        {"provenance": {"data": "synthetic"}},
        {"step": 0, "grad_norm": 1.0, "wire_bytes": 10, "dense_bytes": 40,
         "adapt_rung": 2.0},
        {"step": 1, "grad_norm": 1.5, "wire_bytes": 10, "dense_bytes": 40,
         "adapt_rung": 1.0},
        {"event": "perf_compile", "step": 0, "cache_size": 1},
        {"event": "perf_retrace", "step": 3, "cache_size": 2,
         "retraces": 1},
        {"event": "perf_step_times", "step": 9, "n_steps": 10,
         "mean_ms": 2.0, "p50_ms": 1.9, "p90_ms": 2.5, "p99_ms": 3.0,
         "max_ms": 3.1, "sync_missing": True},
        {"event": "perf_memory", "step": 9, "n_devices": 8,
         "bytes_in_use": 1000, "peak_bytes_in_use": 2000},
        {"event": "perf_state_footprint", "step": 9, "mem_bytes": 288,
         "comp_bytes": 0, "telem_bytes": 640, "footprint_matches": True},
        {"event": "guard_skip", "step": 4, "notfinite_count": 1},
        {"event": "lint_finding", "config": "topk-ring", "pass":
         "numeric_safety", "severity": "error", "stage": "grace/exchange",
         "message": "fp16 accumulation " * 20},
        {"event": "adapt_tighten", "step": 1, "from_rung": 2, "rung": 1},
        {"event": "retune_promote", "step": 7, "old": "a", "new": "b",
         "reason": "drift " * 40},
        "not json",
    ]
    with open(path, "w") as f:
        for r in rows:
            f.write((r if isinstance(r, str) else json.dumps(r)) + "\n")
    return str(path)


def _drift_artifact(path, drift):
    """tests/test_watch.py's artifact through the JAX package's sink and
    detectors."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_watch import _write_artifact
    _write_artifact(str(path), drift=drift)
    return str(path)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A JSONL the port's own JSONLSink wrote: 3 steps of chunk Top-K 10%
    with the telemetry ring and the watch, one gloo rank on the CPU,
    flushed through the reader with the detectors armed."""
    import torch

    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.parallel import init_process_group
    from grace_tpu_torch.telemetry import JSONLSink, TelemetryReader
    from grace_tpu_torch.utils.logging import run_provenance

    path = tmp_path_factory.mktemp("port_run") / "run.jsonl"
    group, _ = init_process_group("cpu")
    try:
        gen = torch.Generator().manual_seed(0)
        params = {"w": torch.randn(40, 30, generator=gen),
                  "b": torch.randn(30, generator=gen)}
        tx = grace_from_params({
            "compressor": "topk", "compress_ratio": 0.1,
            "topk_algorithm": "chunk", "memory": "residual",
            "communicator": "allgather", "telemetry": True, "watch": 1},
            group=group).transform(seed=0)
        state = tx.init(params)
        reader = TelemetryReader(JSONLSink(path, provenance=run_provenance(
            "synthetic", tool="tests/test_torch_tools.py")), every=3,
            anomaly=True)
        for i in range(3):
            grads = {k: torch.randn(v.shape, generator=gen)
                     for k, v in params.items()}
            _, state = tx.update(grads, state)
            reader.update(i, state)
        reader.close()
    finally:
        torch.distributed.destroy_process_group()
    return str(path)


# -- telemetry report ------------------------------------------------------------

@pytest.mark.parametrize("artifact", ["fallback", "watch", "perf",
                                      "port_run"])
@pytest.mark.parametrize("mode", [[], ["--json"],
                                  ["--metrics", "grad_norm,wire_bytes"]])
def test_telemetry_report_equals_the_tool(artifact, mode, tmp_path, capsys,
                                          request):
    from grace_tpu_torch.telemetry import report

    path = {"fallback": lambda: _fallback_run(tmp_path / "a.jsonl"),
            "watch": lambda: _watch_section(tmp_path / "a.jsonl"),
            "perf": lambda: _perf_records(tmp_path / "a.jsonl"),
            "port_run": lambda: request.getfixturevalue("port_run")}[
        artifact]()
    tool = _tool("telemetry_report")
    (jrc, jout), (prc, pout) = _both(capsys, tool.main, report.main,
                                     [path] + mode)
    assert prc == jrc == 0
    if "--json" in mode:
        assert json.loads(pout) == json.loads(jout)
    else:
        assert pout.splitlines() == jout.splitlines()
        assert len(pout.splitlines()) > 8


def test_telemetry_report_sections_of_the_port_run(port_run, capsys):
    """The port's own run: 3 metric rows with the watch's bytes, 3 watch
    summaries, no anomaly; and the empty file exits 1, as the tool's."""
    from grace_tpu_torch.telemetry import report

    assert report.main([port_run, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["records"] == 3 and doc["step_span"] == [0, 2]
    assert len(doc["watch_summaries"]) == 3 and not doc["watch_anomalies"]
    assert doc["metrics"]["watch_bytes"]["count"] == 3
    assert doc["provenance"]["tool"] == "tests/test_torch_tools.py"


def test_telemetry_report_empty_file_exits_1(tmp_path, capsys):
    from grace_tpu_torch.telemetry import report

    path = _rows(tmp_path / "empty.jsonl", [{"provenance": {"data": "x"}}])
    (jrc, jout), (prc, pout) = _both(capsys, _tool("telemetry_report").main,
                                     report.main, [path])
    assert prc == jrc == 1 and pout == jout


# -- watch -------------------------------------------------------------------------

@pytest.mark.parametrize("views", [[], ["--timeline", "--anomalies"],
                                   ["--anomalies", "--kinds", "watch,anomaly",
                                    "--limit", "5"], ["--json", "--anomalies"]])
@pytest.mark.parametrize("artifact", ["drift", "port_run"])
def test_watch_equals_the_tool(artifact, views, tmp_path, capsys, request):
    from grace_tpu_torch.telemetry import watch

    path = (_drift_artifact(tmp_path / "a.jsonl", True) if artifact == "drift"
            else request.getfixturevalue("port_run"))
    tool = _tool("graft_watch")
    docs = []
    capsys.readouterr()
    for main, name in ((tool.main, "jax"), (watch.main, "port")):
        out = tmp_path / f"{name}_WATCH.json"
        assert main([path, "--out", str(out)] + views) == 0
        docs.append((capsys.readouterr().out, json.loads(out.read_text())))
    (jout, jdoc), (pout, pdoc) = docs
    if "--json" in views:
        assert _masked(json.loads(pout), WATCH_OWN) == \
            _masked(json.loads(jout), WATCH_OWN)
    else:
        assert pout.splitlines() == jout.splitlines()
    assert _masked(pdoc, WATCH_OWN) == _masked(jdoc, WATCH_OWN)
    assert pdoc["tool"] == "grace_tpu_torch.telemetry.watch"
    assert jdoc["tool"] == "graft_watch"


def test_watch_baseline_gate_exit_codes_equal_the_tool(tmp_path, capsys):
    """Clean against its own baseline: 0; the drift run against the clean
    baseline: 1 with the same findings; a crash: 2."""
    from grace_tpu_torch.telemetry import watch

    tool = _tool("graft_watch")
    clean = _drift_artifact(tmp_path / "clean.jsonl", False)
    drift = _drift_artifact(tmp_path / "drift.jsonl", True)
    base = str(tmp_path / "BASE.json")
    assert watch.main([clean, "--write-baseline", base, "--out", ""]) == 0
    for argv, rc in (([clean, "--baseline", base], 0),
                     ([drift, "--baseline", base], 1),
                     ([drift, "--baseline", base, "--json"], 1)):
        (jrc, jout), (prc, pout) = _both(capsys, tool.main, watch.main,
                                         argv + ["--out", ""])
        assert prc == jrc == rc
        if "--json" in argv:
            assert _masked(json.loads(pout), WATCH_OWN) == \
                _masked(json.loads(jout), WATCH_OWN)
        else:
            assert pout.splitlines() == jout.splitlines()
    view = json.loads(open(base).read())
    assert set(view) == set(tool.baseline_view({}))
    crash = subprocess.run(
        [sys.executable, "-m", "grace_tpu_torch.telemetry.watch",
         str(tmp_path / "missing.jsonl"), "--out", ""], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert crash.returncode == 2 and "crashed" in crash.stderr


def test_watch_ledger_record(tmp_path, capsys):
    """``--ledger``: the document's ``watch-drill`` record, its capture's
    hash the document's."""
    from grace_tpu_torch.evidence.ledger import load_ledger, sha256_file
    from grace_tpu_torch.telemetry import watch

    art = _drift_artifact(tmp_path / "a.jsonl", True)
    out, led = tmp_path / "W.json", tmp_path / "ledger.jsonl"
    assert watch.main([art, "--json", "--out", str(out),
                       "--ledger", str(led)]) == 0
    (rec,) = load_ledger(str(led))
    assert rec["id"] == "watch-drill" and rec["value"] == 1
    assert rec["capture_sha256"] == sha256_file(str(out))
    assert rec["tool"] == "grace_tpu_torch.telemetry.watch"


# -- profiling ---------------------------------------------------------------------

@pytest.mark.parametrize("mode", [[], ["--json"]])
def test_perf_report_equals_the_tool(mode, tmp_path, capsys):
    from grace_tpu_torch.profiling.__main__ import main

    tool = _tool("perf_report")
    docs = []
    capsys.readouterr()
    for m, name in ((tool.main, "jax"), (main, "port")):
        out = tmp_path / f"{name}_PROF.json"
        assert m(["--trace", FIXTURE, "--out", str(out)] + mode) == 0
        docs.append((capsys.readouterr().out, json.loads(out.read_text())))
    (jout, jdoc), (pout, pdoc) = docs
    if mode:
        assert json.loads(pout) == json.loads(jout)
    else:
        assert pout.splitlines() == jout.splitlines()
    assert _masked(pdoc, PROF_OWN) == _masked(jdoc, PROF_OWN)
    assert pdoc["overlap_fraction"] == pytest.approx(0.25)
    assert "canned CPU fixture" in pdoc["note"]


def test_perf_report_baselines_and_sandwich_equal_the_tool(tmp_path,
                                                           capsys):
    """Its own baseline: 0; the baseline with every stage's ms halved: 1
    with the same findings; ``--overlap-config`` gives the tool's sandwich
    on the fixture (exit 0), an unknown name 2."""
    from grace_tpu_torch.profiling.__main__ import main

    tool = _tool("perf_report")
    base = tmp_path / "base.json"
    assert main(["--trace", FIXTURE, "--out", "", "--write-baseline",
                 str(base)]) == 0
    doc = json.loads(base.read_text())
    doc["stages_ms"] = {k: v / 2 for k, v in doc["stages_ms"].items()}
    halved = tmp_path / "halved.json"
    halved.write_text(json.dumps(doc))
    for b, rc in ((base, 0), (halved, 1)):
        for mode in ([], ["--json"]):
            (jrc, jout), (prc, pout) = _both(
                capsys, tool.main, main,
                ["--trace", FIXTURE, "--out", "", "--baseline", str(b)]
                + mode)
            assert prc == jrc == rc
            if mode:
                assert json.loads(pout) == json.loads(jout)
            else:
                assert pout.splitlines() == jout.splitlines()
    (jrc, jout), (prc, pout) = _both(
        capsys, tool.main, main,
        ["--trace", FIXTURE, "--out", "", "--json", "--overlap-config",
         "topk-allgather-bucketed"])
    assert prc == jrc == 0
    sandwich = json.loads(pout)["overlap_sandwich"]
    assert sandwich == json.loads(jout)["overlap_sandwich"]
    assert sandwich["measured_overlap"] == pytest.approx(0.25)
    assert sandwich["violations"] == []
    assert main(["--trace", FIXTURE, "--out", "", "--overlap-config",
                 "no-such-config"]) == 2


# -- the claim gate ----------------------------------------------------------------

def _gate_tree(tmp_path):
    """A tree with a README whose claims are marked (one cites a record
    whose capture changed since), a CHANGELOG with an unmarked claim, and
    a ledger."""
    from grace_tpu_torch.evidence.ledger import record_artifact

    tree = tmp_path / "tree"
    tree.mkdir()
    cap, stale = tree / "CAP.json", tree / "STALE.json"
    cap.write_text('{"x": 1}\n')
    stale.write_text('{"x": 2}\n')
    led = tmp_path / "ledger.jsonl"
    for path, cid in ((cap, "cap-one"), (stale, "cap-stale")):
        record_artifact(str(path), id=cid, metric="ratio", value=0.98,
                        claim_class="measured", tool="test", platform="gpu",
                        n_devices=1, topology={"world": 1}, config=None,
                        lint_clean=None, git_rev=None, ledger_path=str(led))
    stale.write_text('{"x": 3}\n')
    (tree / "README.md").write_text(
        "# t\n\nruns at 0.98× dense <!-- evidence: cap-one -->\n\n"
        "and 0.97× dense <!-- evidence: cap-stale -->\n")
    (tree / "CHANGELOG.md").write_text("- 1.2× vs dense, unmarked\n")
    return tree, led


def test_gate_equals_the_tool(tmp_path, capsys):
    from grace_tpu_torch.evidence.__main__ import main

    tool = _tool("graft_gate")
    tree, led = _gate_tree(tmp_path)
    base = ["--root", str(tree), "--ledger", str(led)]
    for extra, rc in (([], 0), (["--json"], 0), (["--ci"], 1),
                      (["--ci", "--json"], 1)):
        (jrc, jout), (prc, pout) = _both(capsys, tool.main, main,
                                         base + extra)
        assert prc == jrc == rc
        assert pout == jout
    assert "STALE" in pout and "cap-one" in pout
    readme = (tree / "README.md").read_text()
    (jrc, jout), (prc, pout) = _both(capsys, tool.main, main,
                                     base + ["--update-readme"])
    port_readme = (tree / "README.md").read_text()
    assert prc == jrc == 0
    assert "[graft_gate] README badge block updated" in jout.splitlines()
    assert "[graft_gate] README badge block unchanged" in pout.splitlines()
    assert port_readme != readme and "~~STALE~~" in port_readme
    assert main(["--update-readme"]) == 2


# -- the auditor's evidence ---------------------------------------------------------

ONE_ENTRY = "topk-allgather-bucketed"


def test_lint_evidence_equals_the_tool(tmp_path, monkeypatch, capsys):
    """``--all-configs --evidence`` over a one-entry registry: the JAX
    tool's ``LINT_LAST.json`` but for the writer's fields (its static
    overlap bound, chains and counts equal), and the ``lint-clean`` record
    only where ``--ledger`` names a ledger."""
    import grace_tpu.analysis as jax_analysis

    from grace_tpu_torch.analysis import configs
    from grace_tpu_torch.analysis.__main__ import main
    from grace_tpu_torch.evidence.ledger import load_ledger

    jax_entry = [e for e in jax_analysis.AUDIT_CONFIGS
                 if e["name"] == ONE_ENTRY]
    port_entry = [e for e in configs.AUDIT_CONFIGS if e["name"] == ONE_ENTRY]
    monkeypatch.setattr(jax_analysis, "AUDIT_CONFIGS", jax_entry)
    monkeypatch.setattr(configs, "AUDIT_CONFIGS", port_entry)
    jpath, ppath = tmp_path / "jax.json", tmp_path / "port.json"
    led = tmp_path / "ledger.jsonl"
    assert _tool("graft_lint").main(["--all-configs", "--no-rules",
                                     "--evidence", str(jpath)]) == 0
    assert main(["--all-configs", "--no-rules", "--evidence", str(ppath),
                 "--ledger", str(led)]) == 0
    jdoc, pdoc = (json.loads(p.read_text()) for p in (jpath, ppath))
    assert _masked(pdoc, LINT_OWN) == _masked(jdoc, LINT_OWN)
    assert pdoc["overlap_bounds"][ONE_ENTRY]["static_overlap_bound"] > 0
    assert pdoc["configs_audited"] == 1 and pdoc["rules_checked"] == 0
    (rec,) = load_ledger(str(led))
    assert (rec["id"], rec["value"], rec["lint_clean"]) == \
        ("lint-clean", 1, True)
    capsys.readouterr()
    assert main(["--list"]) == 0
    assert capsys.readouterr().out.split()[0] == ONE_ENTRY


def test_lint_rules_flags(capsys):
    """``--rules-only``: the four repo rules and no trace; ``--no-rules``
    beside ``--rules``: none; ``--list`` names the whole registry."""
    from grace_tpu_torch.analysis.__main__ import main
    from grace_tpu_torch.analysis.configs import AUDIT_CONFIGS

    capsys.readouterr()
    assert main(["--rules-only"]) == 0
    assert "4 repo rule" in capsys.readouterr().out
    assert main(["--rules", "--no-rules", "--config", "none-allreduce"]) == 0
    assert "repo rule" not in capsys.readouterr().out
    assert main(["--list"]) == 0
    names = [line.split()[0] for line in
             capsys.readouterr().out.splitlines()]
    assert names == [e["name"] for e in AUDIT_CONFIGS]


# -- the summary -------------------------------------------------------------------

def test_summary_sections_equal_the_tool(tmp_path, monkeypatch, capsys):
    """The committed documents, copied to a temporary root: each section
    the tool's, and ``main`` prints them in the tool's order; a document
    the port's command lines wrote names the port's command."""
    from grace_tpu_torch.evidence import summary

    es = _tool("evidence_summary")
    for name in DOCS:
        shutil.copy(os.path.join(ROOT, name), tmp_path / name)
    monkeypatch.setattr(es, "ROOT", str(tmp_path))
    readers = dict(es._SECTIONS)
    docs = summary.load_docs(str(tmp_path))
    expected = []
    for base, render in summary.SECTIONS:
        lines = render(docs.get(base), base)
        assert lines == readers[base](es._load), base
        assert lines, base
        expected += lines + [""]
    capsys.readouterr()
    assert summary.main(["--root", str(tmp_path), "--ledger",
                         str(tmp_path / "none.jsonl")]) == 0
    assert capsys.readouterr().out == "\n".join(expected).rstrip() + "\n"
    port_doc = {**docs["PROF_LAST.json"], "tool": "grace_tpu_torch.profiling"}
    assert summary.sec_prof(port_doc)[0].startswith(
        "Performance attribution: `python -m grace_tpu_torch.profiling "
        "--trace")
    port_lint = {**docs["LINT_LAST.json"], "tool": "grace_tpu_torch.analysis"}
    assert "`python -m grace_tpu_torch.analysis --all-configs`" in \
        summary.sec_lint(port_lint)[0]
    assert summary.sec_region({**docs["REGION_LAST.json"], "tool": "x"}) == []


def test_summary_update_readme(tmp_path, capsys):
    from grace_tpu_torch.evidence import summary

    shutil.copy(os.path.join(ROOT, "REGION_LAST.json"), tmp_path)
    (tmp_path / "README.md").write_text(
        "a\n<!-- evidence:begin -->\nold\n<!-- evidence:end -->\nb\n")
    assert summary.main(["--root", str(tmp_path), "--update-readme",
                         "--ledger", str(tmp_path / "none.jsonl")]) == 0
    text = (tmp_path / "README.md").read_text()
    assert "Cross-region elasticity" in text and "old" not in text
    assert text.startswith("a\n") and text.endswith("b\n")
    assert summary.main(["--update-readme"]) == 2


# -- the default outputs -------------------------------------------------------------

def test_default_outputs_lie_under_the_package_and_are_gitignored():
    from grace_tpu_torch.analysis.__main__ import DEFAULT_EVIDENCE
    from grace_tpu_torch.evidence.ledger import LEDGER_PATH
    from grace_tpu_torch.profiling.__main__ import DEFAULT_OUT as PROF
    from grace_tpu_torch.telemetry.watch import DEFAULT_OUT as WATCH

    pkg = os.path.join(ROOT, "grace_tpu_torch") + os.sep
    paths = [DEFAULT_EVIDENCE, PROF, WATCH, LEDGER_PATH]
    for p in paths:
        assert os.path.abspath(p).startswith(pkg), p
    with open(os.path.join(ROOT, ".gitignore")) as f:
        patterns = [line.strip().strip("/") for line in f
                    if line.strip() and not line.startswith("#")]
    for p in paths:
        rel = os.path.relpath(p, ROOT)
        assert any(rel == pat or rel.startswith(pat + "/")
                   for pat in patterns), rel
