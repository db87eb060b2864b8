"""The chaos matrix of ``python -m grace_tpu_torch.resilience.smoke`` at
four gloo ranks, single-rank parameter SDC in both runs (two bit flips,
each repaired by the consensus audit, replicas bit-identical after):
``--sdc --hier`` (over the two-level exchange, slices of two: the rows
carry the per-link split) and ``--sdc --homo`` (NaNs and SDC through the
shared-scale homomorphic QSGD). Each exits 0, its records in the
telemetry artifact."""

from torch_smoke_common import records, run_smoke


def _ok(out):
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[chaos_smoke] OK" in out.stdout
    assert "repairs 2" in out.stdout and "replica_variants 1" in out.stdout


def test_sdc_over_the_hierarchical_exchange(tmp_path):
    out = run_smoke(tmp_path, "--sdc", "--sdc-rank", 2, "--hier",
                    "--slice-size", 2, "--steps", 30, "--nan-prob", 0.05,
                    "--audit-every", 10, "--telemetry-every", 10)
    _ok(out)
    recs = records(tmp_path)
    assert sum(1 for r in recs if r.get("event") == "consensus_repair") == 2
    # The per-link split of the exchange; the audit's bytes ride on top.
    rows = [r for r in recs if "wire_bytes_dcn" in r]
    assert rows and all(r["wire_bytes_ici"] + r["wire_bytes_dcn"]
                        + r["audit_bytes"] == r["wire_bytes"] for r in rows)
    assert any(r["wire_bytes_ici"] > 0 and r["wire_bytes_dcn"] > 0
               for r in rows)


def test_sdc_and_nans_through_the_homomorphic_codec(tmp_path):
    out = run_smoke(tmp_path, "--sdc", "--sdc-rank", 1, "--homo", "--steps",
                    30, "--nan-prob", 0.05, "--audit-every", 10,
                    "--telemetry-every", 10)
    _ok(out)
    recs = records(tmp_path)
    assert recs[0]["provenance"]["homo"] is True
    assert any(r.get("event") == "guard_skip" for r in recs)
