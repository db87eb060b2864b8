"""The port's evidence package against the JAX package's, on the CPU.

Every function is held against ``grace_tpu.evidence`` (or the repository's
``tools/evidence_summary.py`` and ``tools/telemetry_report.py``, loaded
read-only) on the same inputs, exactly, with the time stamps masked:

* ``new_record``'s schema errors; ``append_record``/``load_ledger`` across
  a torn tail; ``record_artifact``'s hashes, paths and rev;
* ``verify_record``'s MEASURED / PROJECTED / STALE verdicts (hash,
  ancestry, class) in a ``git init`` repository under ``tmp_path``, and
  ``git_rev`` None in a tree without ``.git`` nested in a checkout;
* ``scan_claims`` on the repository's ``README.md`` and ``CHANGELOG.md``,
  ``gate_report`` and ``render_badges`` over the repository's
  ``EVIDENCE/ledger.jsonl`` (read, never written), ``splice_badges`` on a
  copy;
* ``backfill_ledger`` over JAX's spec list on synthetic documents, and
  over the port's own curves;
* ``IncidentRecorder`` fed one stream: the same incident files and ledger
  records, debounced alike;
* the summary's sections on the repository's committed drill documents,
  its ledger view, generic table and incident roll-up, and the retune
  trail of ``telemetry.report``;
* the tuner's ``tune-winner`` record.
"""

import hashlib
import json
import os
import shutil
import subprocess

import pytest

import grace_tpu.evidence as jev
from grace_tpu.evidence import backfill as jax_backfill

import grace_tpu_torch.evidence as pev
from grace_tpu_torch.evidence import summary
from grace_tpu_torch.evidence.ledger import git_head_rev

pytestmark = pytest.mark.evidence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = ("timestamp", "captured_at")


def _masked(rec, drop=()):
    return {k: v for k, v in rec.items() if k not in STAMPS + tuple(drop)}


def _load_tool(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"{name}_under_test", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fields(**over):
    rec = {"id": "x", "metric": "m", "value": 1.0,
           "claim_class": "measured", "capture": "c.json",
           "capture_sha256": None, "git_rev": None, "platform": "cpu",
           "chip": "cpu", "n_devices": 1, "topology": {"world": 1},
           "config": None, "lint_clean": None, "tool": "t",
           "timestamp": "2026-01-01T00:00:00+00:00"}
    rec.update(over)
    return {k: v for k, v in rec.items() if v != "<drop>"}


# -- the ledger -------------------------------------------------------------------

def test_ledger_schema_constants_match_jax():
    assert pev.REQUIRED_FIELDS == jev.REQUIRED_FIELDS
    assert pev.CLAIM_CLASSES == jev.CLAIM_CLASSES
    assert pev.STALE_BANNER == jev.STALE_BANNER
    assert pev.LEDGER_PATH == os.path.join(ROOT, "grace_tpu_torch",
                                           "EVIDENCE", "ledger.jsonl")
    assert pev.repo_root() == jev.repo_root()


@pytest.mark.parametrize("over", [
    {"metric": "<drop>"}, {"claim_class": "estimated"}, {"id": ""},
    {"id": 7}, {"topology": [1]}, {}])
def test_new_record_schema_matches_jax(over):
    fields = _fields(**over)
    try:
        want = jev.new_record(**fields)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pev.new_record(**fields)
        assert str(got.value) == str(e)
    else:
        assert pev.new_record(**fields) == want


def test_append_and_load_skip_a_torn_tail_like_jax(tmp_path):
    paths = {}
    for name, mod in (("jax", jev), ("port", pev)):
        path = str(tmp_path / name / "ledger.jsonl")
        for i in range(3):
            mod.append_record(_fields(id=f"r{i % 2}", value=i), path)
        with open(path, "a") as f:
            f.write('{"id": "torn", "metric": ')
        paths[name] = path
    want = jev.load_ledger(paths["jax"])
    assert pev.load_ledger(paths["port"]) == want and len(want) == 3
    assert pev.latest_by_id(want) == jev.latest_by_id(want)
    assert pev.latest_by_id(want)["r0"]["value"] == 2
    assert pev.load_ledger(str(tmp_path / "absent.jsonl")) == []


def test_record_artifact_hashes_like_jax(tmp_path):
    """A capture inside the repository (README.md, read) and one outside:
    the same relative or absolute path, sha256 and HEAD rev."""
    outside = tmp_path / "cap.json"
    outside.write_text('{"a": 1}\n')
    for capture in ("README.md", str(outside)):
        kw = dict(id="c", metric="m", value=2, claim_class="measured",
                  tool="t", platform="gpu", chip="H100, 700.00 W",
                  n_devices=1, topology={"world": 1}, config={"k": 1})
        want = jev.record_artifact(capture, ledger_path=str(
            tmp_path / "j.jsonl"), **kw)
        got = pev.record_artifact(capture, ledger_path=str(
            tmp_path / "p.jsonl"), **kw)
        assert _masked(got) == _masked(want)
    assert got["capture"] == str(outside)
    assert got["capture_sha256"] == hashlib.sha256(
        b'{"a": 1}\n').hexdigest()
    assert want["git_rev"] == git_head_rev() and want["git_rev"]


def _git(repo, *args):
    subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t",
                    *args], cwd=repo, check=True, capture_output=True)


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    """A git repository: a committed capture on main, a commit on a side
    branch (not an ancestor of main's HEAD)."""
    repo = tmp_path_factory.mktemp("repo")
    _git(repo, "init", "-q", "-b", "main")
    (repo / "cap.json").write_text('{"v": 1}\n')
    _git(repo, "add", "cap.json")
    _git(repo, "commit", "-q", "-m", "capture")
    main = subprocess.run(["git", "rev-parse", "HEAD"], cwd=repo,
                          capture_output=True, text=True).stdout.strip()
    _git(repo, "checkout", "-q", "-b", "side")
    (repo / "other.txt").write_text("x\n")
    _git(repo, "add", "other.txt")
    _git(repo, "commit", "-q", "-m", "side")
    side = subprocess.run(["git", "rev-parse", "HEAD"], cwd=repo,
                          capture_output=True, text=True).stdout.strip()
    _git(repo, "checkout", "-q", "main")
    return repo, main, side


def test_verify_record_verdicts_match_jax(repo):
    root, main, side = repo
    sha = hashlib.sha256(b'{"v": 1}\n').hexdigest()
    base = _fields(capture="cap.json", capture_sha256=sha, git_rev=main)
    cases = {
        "measured": base,
        "projected": {**base, "claim_class": "projected",
                      "topology": {"world": 256}},
        "hash": {**base, "capture_sha256": "0" * 64},
        "no-sha": {**base, "capture_sha256": None},
        "missing": {**base, "capture": "gone.json"},
        "no-capture": {**base, "capture": None},
        "class": {**base, "topology": {"world": 8}, "n_devices": 1},
        "not-ancestor": {**base, "git_rev": side},
        "unresolvable": {**base, "git_rev": "f" * 40},
        "no-rev": {**base, "git_rev": None},
        "absent": None}
    statuses = {}
    for name, rec in cases.items():
        want = jev.verify_record(rec, root=str(root))
        assert pev.verify_record(rec, root=str(root)) == want, name
        statuses[name] = want["status"]
    assert statuses["measured"] == "MEASURED"
    assert statuses["projected"] == "PROJECTED"
    assert statuses["no-sha"] == "MEASURED"
    assert {statuses[k] for k in cases
            if k not in ("measured", "projected", "no-sha")} == {"STALE"}
    assert pev.ancestor_verdict(main, str(root)) == "ancestor"
    assert pev.ancestor_verdict(side, str(root)) == "not_ancestor"


def test_a_tree_without_git_has_no_rev(repo):
    """An unpacked archive nested in a checkout: no rev, an unprovable
    ancestry (JAX's git would answer with the enclosing checkout's)."""
    root, main, _ = repo
    nested = root / "archive"
    nested.mkdir(exist_ok=True)
    (nested / "cap.json").write_text('{"v": 2}\n')
    assert git_head_rev(str(nested)) is None
    assert pev.ancestor_verdict(main, str(nested)) == "unknown"
    res = pev.verify_record(_fields(capture="cap.json", git_rev=None),
                            root=str(nested))
    assert res["status"] == "STALE" and res["failures"] == [
        "git_rev None does not resolve in this clone — ancestry "
        "unprovable"]


def test_staleness_detectors_match_jax(repo):
    root, main, side = repo
    docs = [None, {}, {"provenance": {"git_commit": side}},
            {"provenance": {"pallas_enabled": True, "fusion": None,
                            "git_commit": main},
             "rows": [{"config": f"c{i}", "imgs_per_sec": 1.0,
                       "grace_params": {"communicator": "allgather"}}
                      for i in range(3)]}]
    from grace_tpu.evidence import staleness as jst
    for doc in docs:
        assert pev.feature_staleness(doc) == jev.feature_staleness(doc)
        assert pev.evidence_staleness(doc, str(root)) == \
            jev.evidence_staleness(doc, str(root))
    assert pev.evidence_staleness(docs[2], str(root))[-1] == \
        jst.ancestry_staleness(side, str(root))[0]


# -- the claim gate ---------------------------------------------------------------

@pytest.mark.parametrize("doc", ["README.md", "CHANGELOG.md"])
def test_scan_claims_matches_jax(doc):
    with open(os.path.join(ROOT, doc)) as f:
        text = f.read()
    assert pev.scan_claims(text) == jev.scan_claims(text)


def test_gate_report_on_the_repository_ledger_matches_jax():
    """The repository's README/CHANGELOG against the JAX package's ledger,
    read only: the port's gate, given the root and the ledger, equals
    JAX's field for field, and its badge block's text."""
    ledger = os.path.join(ROOT, "EVIDENCE", "ledger.jsonl")
    with open(ledger, "rb") as f:
        before = f.read()
    want = jev.gate_report()
    got = pev.gate_report(root=ROOT, ledger_path=ledger)
    assert got == want and want["records"]
    assert pev.render_badges(got) == jev.render_badges(want)
    with open(ledger, "rb") as f:
        assert f.read() == before


def test_splice_badges_matches_jax_on_a_copy(tmp_path):
    report = jev.gate_report()
    for name, mod in (("jax", jev), ("port", pev)):
        shutil.copy(os.path.join(ROOT, "README.md"), tmp_path / name)
        assert mod.splice_badges(str(tmp_path / name), report)
        assert not mod.splice_badges(str(tmp_path / name), report)
    assert (tmp_path / "port").read_text() == (tmp_path / "jax").read_text()
    assert not pev.splice_badges(str(tmp_path / "absent.md"), report)


# -- backfill ---------------------------------------------------------------------

SYNTHETIC = {
    "BENCH_TPU_LAST.json": {"metric": "m", "vs_baseline": 0.99,
                            "value": 10.0, "platform": "tpu",
                            "chip": "v5e", "n_devices": 1,
                            "captured_at": "2026-01-01T00:00:00"},
    "BENCH_ALL_TPU_LAST.json": {"metric": "s", "vs_baseline": 1.1,
                                "platform": "tpu", "n_devices": 1},
    "BENCH_BERT_TPU_LAST.json": {"metric": "b", "vs_baseline": 0.9},
    "ADAPT_LAST.json": {"tool": "chaos_smoke", "ordering_ok": True,
                        "world": 8, "argv": "--adapt"},
    "ELASTIC_LAST.json": {"floor": {"met": True}, "slice_size": 4},
    "REGION_LAST.json": {"floor": {"met": False}, "slice_size": 4,
                         "region_size": 8},
    "WATCH_LAST.json": {"tool": "graft_watch", "anomalies": 2,
                        "artifact": "a.jsonl"},
    "TUNE_LAST.json": {"tool": "graft_tune", "ok": True,
                       "winner": {"candidate": "w",
                                  "grace_params": {"compressor": "topk"}},
                       "provenance": {"platform": "cpu", "device": "cpu",
                                      "n_devices": 8}},
    "LINT_LAST.json": {"configs_audited": 79, "errors": 0, "warnings": 0,
                       "world": 8},
    "PROF_LAST.json": {"overlap_fraction": 0.25, "trace": "t"},
}


def test_backfill_over_jax_specs_gives_jax_records(tmp_path):
    root = tmp_path / "root"
    root.mkdir()
    for name, doc in SYNTHETIC.items():
        (root / name).write_text(json.dumps(doc))
    (root / "BENCH_ALL_CPU.json").write_text(
        '{"config": "a"}\n{"config": "b"}\n')
    (root / "TPU_VARIANTS.jsonl").write_text('{"v": 1}\n')
    want = jev.backfill_ledger(root=str(root),
                               ledger_path=str(tmp_path / "j.jsonl"))
    got = pev.backfill_ledger(root=str(root),
                              ledger_path=str(tmp_path / "p.jsonl"),
                              specs=jax_backfill._artifact_specs())
    assert [_masked(r) for r in got] == [_masked(r) for r in want]
    assert len(want) == 17
    assert pev.backfill_ledger(root=str(root),
                               ledger_path=str(tmp_path / "p.jsonl"),
                               specs=jax_backfill._artifact_specs()) == []


def test_backfill_of_the_port_curves(tmp_path):
    """The port's default specs: one measured CPU record per curve of its
    examples, none of a TPU capture, idempotent."""
    path = str(tmp_path / "ledger.jsonl")
    recs = pev.backfill_ledger(ledger_path=path)
    curves = sorted(f for f in os.listdir(os.path.join(
        ROOT, "grace_tpu_torch", "examples", "logs"))
        if f.endswith(".tsv") and not f.startswith("jax_"))
    assert [r["capture"] for r in recs] == [
        f"grace_tpu_torch/examples/logs/{f}" for f in curves]
    for r in recs:
        assert r["platform"] == "cpu" and r["claim_class"] == "measured"
        assert 0.0 < r["value"] <= 1.0 and r["git_rev"]
        assert pev.verify_record(r)["status"] == "MEASURED"
    assert pev.backfill_ledger(ledger_path=path) == []


# -- the flight recorder ----------------------------------------------------------

def _stream():
    recs = [{"step": i, "grad_norm": 1.0 + i} for i in range(6)]
    recs += [{"event": "adapt_tighten", "step": 6, "rung": 1,
              "from_rung": 2},
             {"event": "guard_skip", "step": 7, "notfinite_count": 1},
             {"event": "guard_skip", "step": 9, "notfinite_count": 2},
             {"event": "watch", "step": 10},
             {"event": "retune_promote", "step": 40, "new": "powersgd"},
             {"event": "elastic_drain", "step": 50, "rank": 1},
             {"event": "retune_demote", "step": 70, "trigger": "guard"},
             {"event": "retune_drift", "step": 71}]
    return recs


def test_incident_recorder_matches_jax(tmp_path):
    prov = {"platform": "gpu", "device": "H100, 700.00 W", "n_devices": 1}
    out = {}
    for name, mod in (("jax", jev), ("port", pev)):
        rec = mod.IncidentRecorder(str(tmp_path / name), run_tag="drill",
                                   ring_size=8, min_gap_steps=25,
                                   max_incidents=3,
                                   ledger_path=str(tmp_path / f"{name}.l"),
                                   provenance=prov)
        rec.attach_profile({"stages_ms": {"grace/compress": 1.5}})
        with rec:
            for r in _stream():
                rec.write(r)
        docs = []
        for path in rec.incidents:
            with open(path) as f:
                docs.append(_masked(json.load(f)))
        out[name] = (docs, [os.path.basename(p) for p in rec.incidents],
                     mod.load_ledger(str(tmp_path / f"{name}.l")))
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1] == [
        "incident-drill-001-adapt_tighten.json",
        "incident-drill-002-retune_promote.json",
        "incident-drill-003-retune_demote.json"]
    got, want = out["port"][2], out["jax"][2]
    drop = ("capture", "capture_sha256")
    assert [_masked(r, drop) for r in got] == [_masked(r, drop)
                                               for r in want]
    for r in got:
        assert r["capture_sha256"] == pev.sha256_file(r["capture"])


def test_incident_recorder_attaches_a_trace(tmp_path):
    """attach_trace stores profiling.analyze_trace's attribution."""
    trace = {"traceEvents": [
        {"ph": "X", "name": "grace/compress", "cat": "user_annotation",
         "pid": 1, "tid": 1, "ts": 0, "dur": 10},
        {"ph": "X", "name": "aten::add", "cat": "cpu_op", "pid": 1,
         "tid": 1, "ts": 1, "dur": 4}]}
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps(trace))
    rec = pev.IncidentRecorder(str(tmp_path / "inc"),
                               ledger_path=str(tmp_path / "l"))
    rec.attach_trace(str(path))
    rec.write({"event": "guard_skip", "step": 1})
    with open(rec.incidents[0]) as f:
        prof = json.load(f)["prof"]
    assert prof["stages_ms"] == {"grace/compress": 0.01}


# -- the summary ------------------------------------------------------------------

@pytest.mark.parametrize("base,fn", [
    ("ELASTIC_LAST.json", "_sec_elastic"), ("ADAPT_LAST.json", "_sec_adapt"),
    ("RETUNE_LAST.json", "_sec_retune"), ("WATCH_LAST.json", "_sec_watch"),
    ("TUNE_LAST.json", "_sec_tune")])
def test_summary_sections_match_the_tool(base, fn):
    """The repository's committed drill documents (read): each port section
    equals the tool's, and is not empty."""
    tool = _load_tool("evidence_summary")
    with open(os.path.join(ROOT, base)) as f:
        doc = json.load(f)
    want = getattr(tool, fn)(lambda name: doc if name == base else None)
    got = dict(summary.SECTIONS)[base](doc, base)
    assert got == want and want


def test_summary_ledger_views_match_the_tool(tmp_path, monkeypatch):
    """A ledger and incident files under a stand-in root: the tool's
    ledger view, notes, generic table and roll-up equal the port's."""
    tool = _load_tool("evidence_summary")
    root = tmp_path / "root"
    (root / "EVIDENCE" / "incidents").mkdir(parents=True)
    ledger = str(root / "EVIDENCE" / "ledger.jsonl")
    for i, (cap, cls, tool_name) in enumerate([
            ("RETUNE_LAST.json", "measured", "chaos_smoke"),
            ("NEW_LAST.json", "measured", "x"),
            ("NEW_LAST.json", "projected", "x"),
            ("EVIDENCE/incidents/a.json", "measured", "flight_recorder")]):
        jev.append_record(_fields(id=f"id{i}", capture=cap,
                                  claim_class=cls, tool=tool_name), ledger)
    (root / "EVIDENCE" / "incidents" / "a.json").write_text("{}")
    monkeypatch.setattr(tool, "ROOT", str(root))
    want_by, want_latest = tool._ledger_view()
    got_by, got_latest = summary.ledger_view(ledger)
    assert (got_by, got_latest) == (want_by, want_latest)
    for base, recs in got_by.items():
        assert summary.ledger_note(recs) == tool._ledger_note(recs)
        assert summary.generic_section(base, recs) == \
            tool._generic_section(base, recs)
    assert summary.incident_rollup(
        got_latest, str(root / "EVIDENCE" / "incidents"),
        root=str(root)) == tool._incident_rollup(want_latest)
    text = summary.build({}, ledger_path=ledger,
                         incident_dir=str(root / "EVIDENCE" / "incidents"),
                         root=str(root))
    assert "**`NEW_LAST.json`**" in text and "Flight recorder: 1" in text


def test_summary_renders_the_card_drill_document():
    """chip_smoke.py [35]'s document (tool chip_smoke) renders through the
    retune section with its own command."""
    with open(os.path.join(ROOT, "RETUNE_LAST.json")) as f:
        doc = {**json.load(f), "tool": "chip_smoke"}
    lines = summary.sec_retune(doc, "phase35_retune.json")
    assert lines[0].startswith(
        "Online re-tuning (graft-retune): `chip_smoke.py [35]` → ")
    assert "(`phase35_retune.json`" in lines[0]


def test_retune_trail_matches_the_tool():
    from grace_tpu_torch.telemetry.report import render_retune, render_trails
    report = _load_tool("telemetry_report")
    events = [{"event": "retune_drift", "step": 10, "window_mean": 2.5},
              {"event": "retune_prepare", "step": 11, "candidate": "p"},
              {"event": "retune_abort", "step": 11, "leg": "lint",
               "reason": "x" * 200},
              {"event": "retune_promote", "step": 12, "new": "powersgd"},
              {"event": "retune_timeout", "step": 13, "leg": "commit"},
              {"event": "retune_demote", "step": 14, "config": "topk"}]
    assert render_retune(events) == report._render_retune(events)
    records = [{"step": 1, "grad_norm": 1.0}]
    text = report.render(None, records, events)
    trails = "\n".join(render_trails(records, events))
    assert trails and trails in text


# -- the tuner's record -----------------------------------------------------------

def test_tune_winner_record_matches_jax(tmp_path, monkeypatch):
    """The same document through both tuners' evidence writers: the port's
    ledger record equals JAX's but for the tool's name."""
    import grace_tpu.evidence.ledger as jledger
    import grace_tpu.tuning as jtuning

    from grace_tpu_torch.tuning import write_tune_evidence

    doc = SYNTHETIC["TUNE_LAST.json"]
    jpath = tmp_path / "jax" / "TUNE_LAST.json"
    jpath.parent.mkdir()
    monkeypatch.setattr(jtuning, "TUNE_EVIDENCE_PATH", str(jpath))
    real = jledger.record_artifact
    monkeypatch.setattr(jledger, "record_artifact", lambda *a, **k: real(
        *a, ledger_path=str(tmp_path / "j.jsonl"), **k))
    jtuning.write_tune_evidence(doc, str(jpath))
    ppath = tmp_path / "port" / "TUNE_LAST.json"
    ppath.parent.mkdir()
    write_tune_evidence(doc, str(ppath),
                        ledger_path=str(tmp_path / "p.jsonl"))
    write_tune_evidence(doc, str(tmp_path / "port" / "other.json"))
    (want,), (got,) = (jev.load_ledger(str(tmp_path / "j.jsonl")),
                       pev.load_ledger(str(tmp_path / "p.jsonl")))
    drop = ("tool", "capture")
    assert _masked(got, drop) == _masked(want, drop)
    assert got["id"] == "tune-winner" and got["value"] == "w"
    assert got["tool"] == "grace_tpu_torch.tuning"
    assert got["capture"] == str(ppath)
