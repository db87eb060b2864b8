"""The evidence ledger: one append-only JSONL of provenance records;
counterpart of the JAX package's ``evidence/ledger.py``.

Every record names the capture file it attests, the sha256 of that file
at record time, the git rev the capture was taken at, the platform and
chip it ran on, and whether its number is ``measured`` on real devices or
``projected`` through a model. :mod:`~grace_tpu_torch.evidence.gate`
audits document claims against these records.

Append-only with last-writer-wins per ``id``: a re-run appends a fresh
record rather than rewriting history, and :func:`latest_by_id` resolves
the current one. Torn trailing lines (a killed writer) are skipped on
load.

The port keeps its own ledger, :data:`LEDGER_PATH`
(``grace_tpu_torch/EVIDENCE/ledger.jsonl``, outside version control); the
repository's ``EVIDENCE/ledger.jsonl`` is the JAX package's. A record
made on the card has ``platform: "gpu"`` and, as ``chip``, the card's
name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them (:func:`card_chip`). Git is asked
about the checkout itself only: in a tree without ``.git`` (an unpacked
``git archive``) the rev is None, never a parent directory's HEAD.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import subprocess
import sys
from typing import Any, Dict, Iterable, List, Mapping, Optional

__all__ = ["CLAIM_CLASSES", "LEDGER_PATH", "REQUIRED_FIELDS",
           "append_record", "latest_by_id", "load_ledger", "new_record",
           "record_artifact", "repo_root", "sha256_file", "git_head_rev",
           "artifact_rev", "card_chip", "write_json_atomic"]


def repo_root() -> str:
    """The repository root (``grace_tpu_torch/evidence/`` → up 2)."""
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


LEDGER_PATH = os.path.join(repo_root(), "grace_tpu_torch", "EVIDENCE",
                           "ledger.jsonl")

CLAIM_CLASSES = ("measured", "projected")

# The pinned schema (the JAX package's). `topology` is a dict with at
# least `world`; `tiers`, `slice` and `region` ride along when known.
# `config` is the grace_params-style dict (or config name) the number
# belongs to; `lint_clean` whether the config passed the static auditor
# at capture time (None: not audited).
REQUIRED_FIELDS = ("id", "metric", "value", "claim_class", "capture",
                   "capture_sha256", "git_rev", "platform", "chip",
                   "n_devices", "topology", "config", "lint_clean",
                   "tool", "timestamp")


def sha256_file(path: str) -> Optional[str]:
    try:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()
    except OSError:
        return None


def git_env(root: str) -> Dict[str, str]:
    """The environment a git call on ``root`` runs in: discovery stops at
    ``root`` (``GIT_CEILING_DIRECTORIES``), so a tree without ``.git``
    nested in another checkout is no repository."""
    env = dict(os.environ)
    env["GIT_CEILING_DIRECTORIES"] = os.path.dirname(os.path.abspath(root))
    return env


def _git(args: List[str], root: Optional[str] = None) -> Optional[str]:
    root = root or repo_root()
    try:
        out = subprocess.run(["git"] + args, cwd=root, env=git_env(root),
                             capture_output=True, text=True, timeout=10)
    except Exception:
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip() or None


def git_head_rev(root: Optional[str] = None) -> Optional[str]:
    """Full HEAD rev of the checkout, or None without one."""
    return _git(["rev-parse", "HEAD"], root)


def artifact_rev(relpath: str, root: Optional[str] = None) -> Optional[str]:
    """Rev of the last commit that touched ``relpath``: the provenance rev
    of a committed artifact (backfill), an ancestor of HEAD by
    construction."""
    return _git(["log", "-n1", "--format=%H", "--", relpath], root)


def card_chip() -> Optional[str]:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``); None without nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except Exception:
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _utc_now() -> str:
    return datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")


def new_record(**fields: Any) -> Dict[str, Any]:
    """Build and validate a ledger record. Unknown extra keys are kept (the
    schema is a floor); missing required keys and bad claim classes raise,
    so a writer's bug cannot mint half a record."""
    rec = dict(fields)
    rec.setdefault("timestamp", _utc_now())
    missing = [k for k in REQUIRED_FIELDS if k not in rec]
    if missing:
        raise ValueError(f"ledger record missing fields: {missing}")
    if rec["claim_class"] not in CLAIM_CLASSES:
        raise ValueError(
            f"claim_class must be one of {CLAIM_CLASSES}, "
            f"got {rec['claim_class']!r}")
    if not isinstance(rec["id"], str) or not rec["id"]:
        raise ValueError("ledger record needs a non-empty string id")
    topo = rec.get("topology")
    if topo is not None and not isinstance(topo, Mapping):
        raise ValueError("topology must be a dict (world/tiers/slice/"
                         "region) or None")
    return rec


def append_record(record: Mapping[str, Any],
                  path: str = LEDGER_PATH) -> Dict[str, Any]:
    """Validate and append one record: a whole line, flushed and synced, so
    a killed writer leaves at worst a torn tail the loader skips."""
    rec = new_record(**dict(record))
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    line = json.dumps(rec, sort_keys=True, default=str)
    with open(path, "a") as f:
        f.write(line + "\n")
        f.flush()
        os.fsync(f.fileno())
    return rec


def write_json_atomic(path: str, doc: Mapping[str, Any]) -> None:
    """Write an evidence document as indented JSON through a temporary
    file and a rename, so a reader never sees half a document."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_ledger(path: str = LEDGER_PATH) -> List[Dict[str, Any]]:
    records: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except json.JSONDecodeError:
                    continue                     # torn tail line
                if isinstance(doc, dict) and doc.get("id"):
                    records.append(doc)
    except OSError:
        return []
    return records


def latest_by_id(records: Iterable[Mapping[str, Any]]) -> Dict[str, Dict]:
    """The current record of each id: the last one appended."""
    out: Dict[str, Dict] = {}
    for rec in records:
        out[str(rec.get("id"))] = dict(rec)
    return out


def record_artifact(capture_path: str, *, id: str, metric: str,
                    value: Any, claim_class: str, tool: str,
                    platform: Optional[str] = None,
                    chip: Optional[str] = None,
                    n_devices: Optional[int] = None,
                    topology: Optional[Mapping[str, Any]] = None,
                    config: Any = None,
                    lint_clean: Optional[bool] = None,
                    git_rev: Optional[str] = None,
                    ledger_path: str = LEDGER_PATH,
                    **extra: Any) -> Optional[Dict[str, Any]]:
    """The call an evidence writer makes after landing its artifact: hash
    the capture, stamp the current rev, append. It never raises (a failed
    append must not take down the measurement it records): a failure is
    printed to stderr and gives None. A capture inside the repository is
    named by its relative path, one outside by its absolute path."""
    try:
        root = repo_root()
        capture_abs = (capture_path if os.path.isabs(capture_path)
                       else os.path.join(root, capture_path))
        capture_rel = os.path.relpath(capture_abs, root)
        if capture_rel.startswith(".."):
            capture_rel = capture_abs            # outside the repo: keep abs
        rec = new_record(
            id=id, metric=metric, value=value, claim_class=claim_class,
            capture=capture_rel, capture_sha256=sha256_file(capture_abs),
            git_rev=git_rev if git_rev is not None else git_head_rev(root),
            platform=platform, chip=chip, n_devices=n_devices,
            topology=dict(topology) if topology is not None else None,
            config=config, lint_clean=lint_clean, tool=tool, **extra)
        return append_record(rec, ledger_path)
    except Exception as e:                       # noqa: BLE001
        print(f"[evidence] ledger append failed for {id!r}: {e}",
              file=sys.stderr, flush=True)
        return None
