"""``--watch`` (a finite drift on rank 3 flagged by the watch within one
window, the guard silent) and ``--lint --pipeline 2`` (the static auditor
in a child process first, clean, then packed QSGD over the
double-buffered ring) at four gloo ranks: each exits 0."""

from torch_smoke_common import records, run_smoke


def _ok(out):
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[chaos_smoke] OK" in out.stdout


def test_watch_names_the_drifting_rank(tmp_path):
    out = run_smoke(tmp_path, "--watch", "--watch-rank", 3, "--steps", 20,
                    "--telemetry-every", 10)
    _ok(out)
    recs = records(tmp_path)
    hits = [r for r in recs if r.get("event") == "watch_anomaly"
            and r.get("kind") == "skew" and r.get("rank") == 3]
    assert hits and min(r["step"] for r in hits) <= 10
    assert not any(r.get("event") in ("guard_skip", "guard_fallback_engaged")
                   for r in recs)


def test_lint_then_the_pipelined_packed_ring(tmp_path):
    out = run_smoke(tmp_path, "--lint", "--pipeline", 2, "--steps", 20,
                    "--nan-prob", 0.05, "--telemetry-every", 10)
    _ok(out)
    assert "graft-lint: 0 error(s)" in out.stdout
    recs = records(tmp_path)
    assert recs[0]["provenance"]["tool"] == "chaos_smoke"
    assert any(r.get("event") == "guard_skip" for r in recs)
