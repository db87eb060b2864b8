"""What the ``tests/test_torch_smoke_*.py`` files share: one run of
``python -m grace_tpu_torch.resilience.smoke`` on gloo ranks, the key tree
of its evidence document against the committed JAX document's, and the
document through the port's summary and claim gate command lines."""

import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT_S = 240

# The provenance stamp the JAX tool adds to every document it writes
# (its ``_evidence_stamp``); the committed ADAPT, ELASTIC and REGION
# documents predate it.
STAMP = {"git_rev", "n_devices", "topology"}
# The fields the JAX package's ElasticController adds to its drain and
# resize events since the region drill (the committed ELASTIC document
# predates them; REGION_LAST.json carries them).
EVENT_FIELDS = {"scope", "drain_timeouts", "region_size", "whole_regions"}


def run_smoke(tmp, *argv, world=4, timeout=TIMEOUT_S):
    """One drill on ``world`` gloo ranks, its telemetry in ``tmp``."""
    cmd = [sys.executable, "-m", "grace_tpu_torch.resilience.smoke",
           "--device", "cpu", "--world", str(world),
           "--telemetry-out", str(pathlib.Path(tmp) / "run.jsonl"),
           *map(str, argv)]
    return subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


def records(tmp):
    with open(pathlib.Path(tmp) / "run.jsonl") as f:
        return [json.loads(line) for line in f]


def _kind(v):
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, (int, float)):
        return "int" if isinstance(v, int) else "float"
    return type(v).__name__


def key_tree_diff(port, jax, path="", extra=frozenset(), absent=frozenset(),
                  nullable=frozenset(), data_keyed=frozenset()):
    """The differences between two documents' key trees and value types,
    recursively (lists item by item). ``extra``: keys the port's document
    may add; ``absent``: paths (``a.b``) the port may leave out;
    ``nullable``: paths that may be null in the port's; ``data_keyed``:
    paths whose keys are data (only the value types are compared)."""
    out = []
    if port is None and path in nullable:
        return out
    if isinstance(jax, dict) and isinstance(port, dict):
        if path in data_keyed:
            kinds = {_kind(v) for v in list(jax.values())
                     + list(port.values())}
            return [] if len(kinds) <= 1 else [f"{path}: {kinds}"]
        for k in jax:
            sub = f"{path}.{k}" if path else k
            if k not in port:
                if sub not in absent:
                    out.append(f"{sub}: missing")
                continue
            out += key_tree_diff(port[k], jax[k], sub, extra, absent,
                                 nullable, data_keyed)
        out += [f"{path}.{k}: extra" for k in port
                if k not in jax and k not in extra]
        return out
    if isinstance(jax, list) and isinstance(port, list):
        if len(jax) != len(port) and all(not isinstance(v, (dict, list))
                                         for v in jax + port):
            kinds = {_kind(v) for v in jax + port}
            return [] if len(kinds) <= 1 else [f"{path}: {kinds}"]
        if len(jax) != len(port):
            return [f"{path}: {len(port)} items, JAX's {len(jax)}"]
        for i, (p, j) in enumerate(zip(port, jax)):
            out += key_tree_diff(p, j, f"{path}[{i}]", extra, absent,
                                 nullable, data_keyed)
        return out
    if _kind(port) != _kind(jax):
        out.append(f"{path}: {_kind(port)}, JAX's {_kind(jax)}")
    return out


def committed(name):
    return json.loads((REPO / name).read_text())


def _git_head():
    out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                         capture_output=True, text=True)
    return out.stdout.strip() if out.returncode == 0 else None


def render_and_gate(tmp, doc_path, name, ledger_id, heading):
    """The document renders in ``python -m grace_tpu_torch.evidence.
    summary`` under ``heading``, and ``python -m grace_tpu_torch.evidence``
    verifies the ledger record its drill appended. Returns the summary."""
    tmp = pathlib.Path(tmp)
    docs = tmp / "docs"
    docs.mkdir(exist_ok=True)
    (docs / name).write_text(pathlib.Path(doc_path).read_text())
    ledger = tmp / "ledger.jsonl"
    md = subprocess.run(
        [sys.executable, "-m", "grace_tpu_torch.evidence.summary", "--root",
         str(docs), "--ledger", str(ledger)], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert md.returncode == 0, md.stderr[-2000:]
    line = next((ln for ln in md.stdout.splitlines() if heading in ln), None)
    assert line is not None, md.stdout[-3000:]
    claims = tmp / "claims.md"
    claims.write_text(f"The drill's verdict.\n<!-- evidence: {ledger_id} "
                      "-->\n")
    gate = subprocess.run(
        [sys.executable, "-m", "grace_tpu_torch.evidence", "--json",
         "--ledger", str(ledger), "--doc", str(claims)], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert gate.returncode == 0, gate.stderr[-2000:]
    res = json.loads(gate.stdout)["records"][ledger_id]
    if _git_head() is not None:
        assert res["status"] == "MEASURED", res
    else:                                    # a tree without .git
        assert res["status"] in ("MEASURED", "STALE"), res
    return line
