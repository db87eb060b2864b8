"""``--retune`` at four gloo ranks (fleet drift → a two-phase promotion →
probation → back → a sabotaged promotion demoted bit for bit): exit 0,
and its document has the key tree and value types of the committed JAX
``RETUNE_LAST.json`` (the funnel left out: it runs with
``--retune-funnel``), renders in the port's summary and passes its claim
gate. And ``--adapt`` at one rank (``--adapt-rank 0``), as the card's
smoke runs it."""

import json

from torch_smoke_common import (STAMP, committed, key_tree_diff,
                                render_and_gate, run_smoke)


def test_retune_drill_and_its_document(tmp_path):
    doc = tmp_path / "RETUNE.json"
    out = run_smoke(tmp_path, "--retune", "--retune-probation", 10,
                    "--telemetry-every", 5, "--retune-out", doc, "--ledger",
                    tmp_path / "ledger.jsonl")
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(doc.read_text())
    assert key_tree_diff(got, committed("RETUNE_LAST.json"), extra=STAMP,
                         nullable={"funnel"},
                         absent={"first_steps.retune_measure"}) == []
    assert got["funnel"] is None
    sab = got["sabotage"]
    assert sab["restored"] and sab["bit_exact"] and sab["within_probation"]
    assert got["ordering_ok"]
    line = render_and_gate(tmp_path, doc, "RETUNE_LAST.json",
                           "retune-drill", "`chaos_smoke --retune`")
    assert "bit-exact" in line


def test_adapt_at_one_rank(tmp_path):
    doc = tmp_path / "ADAPT1.json"
    out = run_smoke(tmp_path, "--adapt", "--adapt-rank", 0, "--steps", 60,
                    "--adapt-window", 6, "--telemetry-every", 6,
                    "--adapt-out", doc, world=1)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(doc.read_text())["world"] == 1
