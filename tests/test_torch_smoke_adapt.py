"""``--adapt`` at four gloo ranks (drift → tighten before any guard event →
quiet → loosen → NaN → escalate): exit 0, and its document has the key
tree and value types of the committed JAX ``ADAPT_LAST.json``, renders in
the port's summary and passes its claim gate; and ``--fsdp`` over a 2×2
dp×fsdp mesh: exit 0."""

import json

from torch_smoke_common import (STAMP, committed, key_tree_diff,
                                render_and_gate, run_smoke)


def test_adapt_drill_and_its_document(tmp_path):
    doc = tmp_path / "ADAPT.json"
    out = run_smoke(tmp_path, "--adapt", "--steps", 60, "--adapt-window", 6,
                    "--telemetry-every", 6, "--adapt-out", doc, "--ledger",
                    tmp_path / "ledger.jsonl")
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(doc.read_text())
    assert key_tree_diff(got, committed("ADAPT_LAST.json"),
                         extra=STAMP) == []
    assert got["ordering_ok"] and got["tighten"]["within_one_window"]
    assert got["world"] == 4 and got["topology"]["world"] == 4
    line = render_and_gate(tmp_path, doc, "ADAPT_LAST.json", "adapt-drill",
                           "`chaos_smoke --adapt`")
    assert "adapt_tighten precedes the first guard event" in line


def test_fsdp_drill_over_a_two_by_two_mesh(tmp_path):
    out = run_smoke(tmp_path, "--fsdp", "--sdc-rank", 1, "--steps", 30,
                    "--nan-prob", 0.05, "--audit-every", 10,
                    "--telemetry-every", 10)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "dp2×fsdp2" in out.stdout and "repairs 2" in out.stdout
