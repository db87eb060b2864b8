"""Provenance evidence; counterpart of the JAX package's ``evidence/``.

* :mod:`~grace_tpu_torch.evidence.ledger`: the append-only JSONL of
  provenance records (the port's own, ``grace_tpu_torch/EVIDENCE/
  ledger.jsonl``): each names its capture file and that file's sha256,
  the git rev, the platform, chip and device count, and the claim class
  (``measured`` or ``projected``).
* :mod:`~grace_tpu_torch.evidence.staleness`: the staleness detector,
  feature stamps and git ancestry.
* :mod:`~grace_tpu_torch.evidence.gate`: the claim gate, document claim
  markers (``<!-- evidence: <ledger-id> -->``) verified against the
  ledger and rendered as MEASURED / PROJECTED / STALE badges.
* :mod:`~grace_tpu_torch.evidence.backfill`: records minted from
  committed artifacts.
* :mod:`~grace_tpu_torch.evidence.incident`: the flight recorder, a
  telemetry sink that snapshots the recent records, the timeline, the
  adapt rung history and an attached stage attribution into a
  ledger-attached incident file when a guard trips, the ladder tightens,
  a drain fires or a retune promotes or demotes.
* :mod:`~grace_tpu_torch.evidence.summary`: the markdown renderers of the
  ledger, the incidents and the resilience drills' documents.

Host code only: the ledger, the gate and the backfill import no torch.
"""

from grace_tpu_torch._lazy import lazy_exports

__all__ = [
    "CLAIM_CLASSES", "LEDGER_PATH", "REQUIRED_FIELDS",
    "append_record", "latest_by_id", "load_ledger", "new_record",
    "record_artifact", "repo_root", "sha256_file",
    "STALE_BANNER", "ancestor_verdict", "evidence_staleness",
    "feature_staleness", "head_rev",
    "gate_report", "render_badges", "scan_claims", "splice_badges",
    "verify_record",
    "backfill_ledger", "IncidentRecorder",
]

__getattr__, __dir__ = lazy_exports(__name__, {
    ".ledger": ("CLAIM_CLASSES", "LEDGER_PATH", "REQUIRED_FIELDS",
                "append_record", "latest_by_id", "load_ledger", "new_record",
                "record_artifact", "repo_root", "sha256_file"),
    ".staleness": ("STALE_BANNER", "ancestor_verdict", "evidence_staleness",
                   "feature_staleness", "head_rev"),
    ".gate": ("gate_report", "render_badges", "scan_claims", "splice_badges",
              "verify_record"),
    ".backfill": ("backfill_ledger",),
    ".incident": ("IncidentRecorder",)})
