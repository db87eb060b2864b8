"""``--elastic`` at four gloo ranks (rank 2 drifts, drains, leaves; three
ranks train; it rejoins behind one barrier repair) and ``--region`` at
eight (2 regions × 2 slices × 2 ranks, the last region leaves and rejoins):
each exits 0, and its document has the key tree and value types of the
committed JAX document, renders in the port's summary and passes its
claim gate."""

import json

from torch_smoke_common import (EVENT_FIELDS, STAMP, committed,
                                key_tree_diff, render_and_gate, run_smoke)


def test_elastic_drill_and_its_document(tmp_path):
    doc = tmp_path / "ELASTIC.json"
    out = run_smoke(tmp_path, "--elastic", "--elastic-rank", 2, "--steps",
                    40, "--watch-window", 5, "--telemetry-every", 10,
                    "--elastic-out", doc, "--ledger",
                    tmp_path / "ledger.jsonl")
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(doc.read_text())
    assert key_tree_diff(got, committed("ELASTIC_LAST.json"),
                         extra=STAMP | EVENT_FIELDS,
                         data_keyed={"footprint"}) == []
    assert got["world_cycle"] == [4, 3, 4]
    assert got["rejoin"]["barrier_repairs"] == 1
    assert got["rejoin"]["replica_variants"] == 1
    assert [e["event"] for e in got["resize_events"]] == [
        "elastic_drain", "elastic_resize", "elastic_resize",
        "elastic_rejoin"]
    render_and_gate(tmp_path, doc, "ELASTIC_LAST.json", "elastic-drill",
                    "`chaos_smoke --elastic`")


def test_region_drill_and_its_document(tmp_path):
    doc = tmp_path / "REGION.json"
    out = run_smoke(tmp_path, "--region", "--steps", 40, "--watch-window",
                    5, "--telemetry-every", 10, "--region-out", doc,
                    "--ledger", tmp_path / "ledger.jsonl", world=8)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(doc.read_text())
    assert key_tree_diff(got, committed("REGION_LAST.json"), extra=STAMP,
                         data_keyed={"drain.episodes", "footprint"}) == []
    assert got["world_cycle"] == [8, 4, 8]
    assert got["drain"]["scope"] == [4, 5, 6, 7]
    assert got["drain"]["transitions"] == 1
    render_and_gate(tmp_path, doc, "REGION_LAST.json", "region-drill",
                    "`chaos_smoke --region`")
