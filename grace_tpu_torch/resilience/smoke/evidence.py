"""The drills' evidence documents: the provenance stamp, the one writer
(atomic, then a ledger record) and the flight-recorder sink; the
counterpart of ``tools/chaos_smoke.py``'s ``_evidence_stamp``,
``_write_evidence_doc`` and ``_incident_sink``."""

from __future__ import annotations

import json
import os
from typing import Optional

from grace_tpu_torch.resilience.smoke.common import PKG_DIR, say


def evidence_stamp(world: int, slice_size=None, region_size=None) -> dict:
    """The provenance every drill document carries: the git rev, the
    device count and the topology (its tiers, slice and region)."""
    from grace_tpu_torch.evidence.ledger import git_head_rev
    tiers = ["ici"]
    if slice_size:
        tiers.append("dcn")
    if region_size:
        tiers.append("wan")
    return {"git_rev": git_head_rev(),
            "n_devices": world,
            "topology": {"world": world, "tiers": tiers,
                         "slice": slice_size or None,
                         "region": region_size or None}}


def ledger_for(out_path: str, ledger: Optional[str]) -> Optional[str]:
    """The ledger a document's record goes to: ``ledger`` when given, the
    port's own ledger for a document at its default place in the package,
    none otherwise (a run against a scratch path leaves the ledger
    alone)."""
    from grace_tpu_torch.evidence.ledger import LEDGER_PATH
    if ledger:
        return ledger
    if os.path.dirname(os.path.abspath(out_path)) == PKG_DIR:
        return LEDGER_PATH
    return None


def write_evidence_doc(doc: dict, out_path: str, *, ledger_id: str,
                       metric: str, value, world: int, device,
                       ledger: Optional[str] = None, slice_size=None,
                       region_size=None, label: str = "evidence") -> None:
    """Stamp, write atomically and record one drill document (first rank
    only: the caller checks)."""
    from grace_tpu_torch.evidence.ledger import card_chip, record_artifact
    doc = {**doc, **evidence_stamp(world, slice_size, region_size)}
    parent = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(parent, exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    os.replace(tmp, out_path)
    say(f"{label}: {out_path}")
    path = ledger_for(out_path, ledger)
    if path is None:
        return
    gpu = getattr(device, "type", str(device)) == "cuda"
    record_artifact(
        out_path, id=ledger_id, metric=metric, value=value,
        claim_class="measured", tool="chaos_smoke",
        platform="gpu" if gpu else "cpu",
        chip=(card_chip() if gpu else None) or ("gpu" if gpu else "cpu"),
        n_devices=world, topology=doc["topology"], config=doc.get("argv"),
        lint_clean=None, git_rev=doc["git_rev"], ledger_path=path)


def incident_sink(jsonl_sink, args, provenance, tag: str):
    """The JSONL sink wrapped with the flight recorder when
    ``--incidents`` names a directory (first rank only): the same record
    stream, plus an incident snapshot on each guard trip, adapt
    escalation, drain and retune transition. Returns ``(sink,
    recorder)``."""
    from grace_tpu_torch.resilience.smoke.common import rank_of
    if not getattr(args, "incidents", None) or jsonl_sink is None \
            or rank_of() != 0:
        return jsonl_sink, None
    from grace_tpu_torch.evidence.incident import IncidentRecorder
    from grace_tpu_torch.telemetry import MultiSink
    recorder = IncidentRecorder(args.incidents, run_tag=tag,
                                provenance=provenance,
                                ledger_path=args.ledger or None)
    return MultiSink(jsonl_sink, recorder), recorder
