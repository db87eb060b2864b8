"""Backfill: mint ledger records from committed artifacts; counterpart of
the JAX package's ``evidence/backfill.py``.

Every artifact gets records whose ``git_rev`` is the last commit that
touched the file (``git log -n1 -- <path>``), an ancestor of HEAD by
construction, so honest history backfills clean and only a rewrite or a
hand-edited capture renders STALE. Idempotent: an id whose latest record
already names the same capture sha is skipped.

A spec is ``{"capture": <path relative to root>, "build": doc -> [record
dicts], "load": path -> doc (optional; JSON or JSON lines by default)}``.
The port's default specs (:func:`artifact_specs`) name only the port's
own committed artifacts: the LeNet curves under
``grace_tpu_torch/examples/logs/``, CPU runs of the port's examples. No
TPU capture enters the port's ledger. :func:`backfill_ledger` takes any
spec list, the JAX package's included.

Run: ``python -m grace_tpu_torch.evidence.backfill``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from grace_tpu_torch.evidence.ledger import (LEDGER_PATH, artifact_rev,
                                             latest_by_id, load_ledger,
                                             record_artifact, repo_root,
                                             sha256_file)

__all__ = ["backfill_ledger", "artifact_specs", "load_doc", "load_curve"]

CURVE_DIR = os.path.join("grace_tpu_torch", "examples", "logs")


def load_doc(path: str) -> Optional[Any]:
    """One JSON document, or the list of documents of a JSON-lines file."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return None
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        docs = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                docs.append(json.loads(line))
            except json.JSONDecodeError:
                continue
        return docs or None


def load_curve(path: str) -> Optional[Dict[str, Any]]:
    """A training-curve TSV of the port's examples: ``{"header": {key:
    value}, "rows": [[epoch, loss, accuracy], ...]}`` (the ``# key:
    value`` provenance lines, then tab-separated rows)."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return None
    header: Dict[str, str] = {}
    rows: List[List[float]] = []
    for line in lines:
        if line.startswith("#"):
            key, _, value = line[1:].partition(":")
            header[key.strip()] = value.strip()
        elif line.strip():
            try:
                rows.append([float(v) for v in line.split("\t")])
            except ValueError:
                continue                     # a column-name line
    return {"header": header, "rows": rows} if rows else None


def _cpu_topo(world: int) -> Dict[str, Any]:
    return {"world": world, "tiers": ["ici"], "slice": None, "region": None}


def _curve_records(name: str, curve: Mapping[str, Any]
                   ) -> List[Dict[str, Any]]:
    head = curve["header"]
    world = int(head.get("world") or head.get("world_size") or 1)
    try:
        config = json.loads(head["config"]) if "config" in head else None
    except json.JSONDecodeError:
        config = head.get("config")
    tool = ("grace_tpu_torch.examples.digits_lenet"
            if name.startswith("digits_")
            else "grace_tpu_torch.examples.mnist10k_lenet")
    return [{
        "id": f"curve-{name}", "metric": "final_test_accuracy",
        "value": curve["rows"][-1][-1], "claim_class": "measured",
        "tool": tool, "platform": head.get("platform", "cpu"),
        "chip": head.get("device", "cpu"),
        # World ranks of a gloo group share the host: a CPU run is one
        # device per rank, as the JAX package counts its CPU mesh.
        "n_devices": world, "topology": _cpu_topo(world),
        "config": config, "lint_clean": None,
        "epochs": len(curve["rows"]), "data": head.get("data"),
        "captured_at": head.get("generated_utc"),
    }]


def artifact_specs(root: Optional[str] = None) -> List[Dict[str, Any]]:
    """The port's committed artifacts: one spec per LeNet curve of the
    port's examples (``jax_*`` curves are the JAX package's runs, kept
    there for comparison, and left out)."""
    root = root or repo_root()
    specs = []
    for path in sorted(glob.glob(os.path.join(root, CURVE_DIR, "*.tsv"))):
        name = os.path.splitext(os.path.basename(path))[0]
        if name.startswith("jax_"):
            continue
        specs.append({"capture": os.path.join(CURVE_DIR,
                                              os.path.basename(path)),
                      "load": load_curve,
                      "build": (lambda d, name=name:
                                _curve_records(name, d))})
    return specs


def backfill_ledger(root: Optional[str] = None,
                    ledger_path: Optional[str] = None,
                    verbose: bool = False,
                    specs: Optional[Sequence[Mapping[str, Any]]] = None
                    ) -> List[Dict[str, Any]]:
    """Mint records for every artifact of ``specs`` (default:
    :func:`artifact_specs`) not yet in the ledger at ``ledger_path``
    (default: the port's). Returns the records appended."""
    root = root or repo_root()
    ledger_path = ledger_path or LEDGER_PATH
    current = latest_by_id(load_ledger(ledger_path))
    appended: List[Dict[str, Any]] = []
    for spec in (artifact_specs(root) if specs is None else specs):
        rel = spec["capture"]
        path = os.path.join(root, rel)
        load: Callable[[str], Any] = spec.get("load") or load_doc
        doc = load(path)
        if doc is None:
            continue
        sha = sha256_file(path)
        rev = artifact_rev(rel, root)
        for rec in spec["build"](doc):
            prior = current.get(rec["id"])
            if prior is not None and prior.get("capture_sha256") == sha:
                continue                       # already minted for this sha
            out = record_artifact(
                path, ledger_path=ledger_path, git_rev=rev,
                **{k: v for k, v in rec.items() if k != "capture"})
            if out is not None:
                appended.append(out)
                current[out["id"]] = out
                if verbose:
                    print(f"[backfill] {out['id']}: "
                          f"{out['claim_class']} {out['metric']} "
                          f"@ {str(rev)[:12]}")
    return appended


if __name__ == "__main__":
    recs = backfill_ledger(verbose=True)
    print(f"[backfill] appended {len(recs)} record(s) to {LEDGER_PATH}")
