"""The claim gate: documents' quantitative claims must cite evidence;
counterpart of the JAX package's ``evidence/gate.py``.

* A **claim marker** is an HTML comment naming one or more ledger ids, in
  the same paragraph as the claim it backs::

      measures 0.9895× dense single-chip <!-- evidence: bench-headline-tpu -->

* A **quantitative claim line** is a prose line with a ratio-against-dense
  pattern (``0.9897×``, ``1.09–1.11×``, ``>1× vs dense``), outside fenced
  code and outside the generated ``<!-- evidence:begin/end -->`` and gate
  blocks. A paragraph with a marker covers every claim line in it; a
  marker on a line of its own also covers the paragraphs beside it.

* **Verification** of a cited record: the capture's sha256 still matches;
  the record's ``git_rev`` is an ancestor of HEAD (strict: an
  unresolvable rev is STALE, as in a tree without ``.git``); and a
  ``measured`` record's topology world does not exceed its ``n_devices``.

Verdicts: **MEASURED** / **PROJECTED** / **STALE**. :func:`gate_report`
takes the tree, the ledger and the documents explicitly, so it audits the
port's own ledger (the default) or any other.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

from grace_tpu_torch.evidence.ledger import (latest_by_id, load_ledger,
                                             repo_root, sha256_file)
from grace_tpu_torch.evidence.staleness import ancestor_verdict

__all__ = ["MARKER_RE", "CLAIM_RE", "scan_claims", "verify_record",
           "gate_report", "render_badges", "splice_badges",
           "GATE_BEGIN", "GATE_END"]

# <!-- evidence: id-one id-two --> — ids split on comma/whitespace.
MARKER_RE = re.compile(r"<!--\s*evidence:\s*([A-Za-z0-9_.,:\s/-]+?)\s*-->")

# Marker "ids" that are block fences, not citations.
_FENCE_IDS = frozenset({"begin", "end"})

# A ratio token: ~0.98×, 1.09–1.11x, >1×, 8.7× — but not "0x1f" hex or
# "2xlarge"-style words (the lookahead kills a trailing word char).
_RATIO = r"[>~]?\d+(?:\.\d+)?(?:\s*[-–]\s*\d+(?:\.\d+)?)?\s*[×x](?![a-wyz0-9])"
# A quantitative claim: a ratio on a line that talks about dense.
CLAIM_RE = re.compile(rf"(?:{_RATIO})(?=.*\bdense\b)|(?:\bdense\b.*?{_RATIO})",
                      re.IGNORECASE)

GATE_BEGIN = "<!-- evidence-gate:begin -->"
GATE_END = "<!-- evidence-gate:end -->"


def _marker_ids(line: str) -> List[str]:
    ids: List[str] = []
    for m in MARKER_RE.finditer(line):
        for tok in re.split(r"[,\s]+", m.group(1).strip()):
            if tok and tok not in _FENCE_IDS:
                ids.append(tok)
    return ids


def _paragraphs(lines: List[str]) -> List[int]:
    """The paragraph index of each line (-1 for a blank line)."""
    para_of: List[int] = []
    para = -1
    prev_blank = True
    for raw in lines:
        blank = not raw.strip()
        if blank:
            para_of.append(-1)
        else:
            if prev_blank:
                para += 1
            para_of.append(para)
        prev_blank = blank
    return para_of


def scan_claims(text: str) -> Dict[str, Any]:
    """Scan one markdown document: ``{"claims": [(lineno, line)],
    "cited_ids": [...], "unmarked": [(lineno, line)]}``, ``unmarked``
    being the claim lines whose paragraph has no marker."""
    lines = text.split("\n")
    para_of = _paragraphs(lines)
    fence = in_evidence_block = in_gate_block = False
    marked_paras = set()
    cited: List[str] = []
    claims: List[Tuple[int, str]] = []
    for i, raw in enumerate(lines):
        stripped = raw.strip()
        if stripped.startswith("```"):
            fence = not fence
            continue
        if "<!-- evidence:begin -->" in raw:
            in_evidence_block = True
        if "<!-- evidence:end -->" in raw:
            in_evidence_block = False
            continue
        # The gate's own block quotes failing claims; generated, like the
        # evidence block, so never scanned.
        if GATE_BEGIN in raw:
            in_gate_block = True
        if GATE_END in raw:
            in_gate_block = False
            continue
        ids = _marker_ids(raw)
        if ids:
            cited.extend(ids)
            if para_of[i] >= 0:
                marked_paras.add(para_of[i])
            for j in (i - 1, i + 1):
                if 0 <= j < len(para_of) and para_of[j] >= 0:
                    marked_paras.add(para_of[j])
        if fence or in_evidence_block or in_gate_block:
            continue
        if stripped.startswith("<!--"):
            continue
        if CLAIM_RE.search(raw):
            claims.append((i + 1, raw.strip()))

    unmarked = [(n, l) for (n, l) in claims
                if para_of[n - 1] not in marked_paras]
    return {"claims": claims, "cited_ids": cited, "unmarked": unmarked}


def verify_record(rec: Optional[Mapping[str, Any]], *,
                  root: Optional[str] = None,
                  head: str = "HEAD") -> Dict[str, Any]:
    """One record → ``{"status": MEASURED|PROJECTED|STALE, "failures":
    [...], "notes": [...]}``; ``rec=None`` is a cited id with no record."""
    root = root or repo_root()
    failures: List[str] = []
    notes: List[str] = []
    if rec is None:
        return {"status": "STALE", "failures": ["no ledger record"],
                "notes": []}

    capture = rec.get("capture")
    recorded_sha = rec.get("capture_sha256")
    if capture:
        cap_abs = (capture if os.path.isabs(capture)
                   else os.path.join(root, capture))
        actual = sha256_file(cap_abs)
        if actual is None:
            failures.append(f"capture file missing: {capture}")
        elif recorded_sha and actual != recorded_sha:
            failures.append(
                f"capture hash mismatch: {capture} changed since the "
                "record was minted (re-run the writer or re-backfill)")
        elif not recorded_sha:
            notes.append("record carries no capture_sha256")
    else:
        failures.append("record names no capture file")

    verdict = ancestor_verdict(rec.get("git_rev"), root, head)
    if verdict == "not_ancestor":
        failures.append(
            f"git_rev {rec.get('git_rev')} is not an ancestor of {head}")
    elif verdict == "unknown":
        failures.append(
            f"git_rev {rec.get('git_rev')!r} does not resolve in this "
            "clone — ancestry unprovable")
    elif verdict == "no_git":
        notes.append("git unavailable; ancestry unchecked")

    # The claim's world is topology.world (what the number is about);
    # n_devices is what ran.
    n_dev = rec.get("n_devices")
    topo = rec.get("topology") or {}
    world = topo.get("world") if isinstance(topo, Mapping) else None
    if (rec.get("claim_class") == "measured" and
            isinstance(world, (int, float)) and
            isinstance(n_dev, (int, float)) and world > n_dev):
        failures.append(
            f"class mismatch: claim_class 'measured' for a world-{world} "
            f"topology backed by an n_devices={n_dev} capture — that is "
            "a projection and must say so")

    if failures:
        status = "STALE"
    else:
        status = ("MEASURED" if rec.get("claim_class") == "measured"
                  else "PROJECTED")
    return {"status": status, "failures": failures, "notes": notes}


def gate_report(root: Optional[str] = None,
                ledger_path: Optional[str] = None,
                docs: Tuple[str, ...] = ("README.md", "CHANGELOG.md"),
                head: str = "HEAD") -> Dict[str, Any]:
    """Audit the claims of ``docs`` (paths relative to ``root``, or
    absolute) against the ledger at ``ledger_path`` (default: the port's,
    under ``root``). ``ok``: no unmarked claim, and no cited record that
    verifies STALE."""
    root = root or repo_root()
    ledger_path = ledger_path or os.path.join(
        root, "grace_tpu_torch", "EVIDENCE", "ledger.jsonl")
    records = latest_by_id(load_ledger(ledger_path))
    report: Dict[str, Any] = {"root": root, "ledger": ledger_path,
                              "docs": {}, "records": {}, "ok": True,
                              "failures": []}
    cited: List[str] = []
    for doc in docs:
        try:
            with open(os.path.join(root, doc)) as f:
                scan = scan_claims(f.read())
        except OSError:
            continue
        report["docs"][doc] = scan
        cited.extend(scan["cited_ids"])
        for lineno, line in scan["unmarked"]:
            report["failures"].append(
                f"{doc}:{lineno}: unmarked quantitative claim: {line}")

    for cid in sorted(set(cited)):
        res = verify_record(records.get(cid), root=root, head=head)
        res["record"] = records.get(cid)
        report["records"][cid] = res
        if res["status"] == "STALE":
            for f in res["failures"]:
                report["failures"].append(f"record {cid}: {f}")

    report["ok"] = not report["failures"]
    return report


def render_badges(report: Mapping[str, Any]) -> str:
    """The badge block: one row per cited record, verdict first (the JAX
    package's text, its generator line included)."""
    lines = [GATE_BEGIN,
             "<!-- generated by tools/graft_gate.py --update-readme; "
             "do not edit by hand -->",
             "",
             "| claim id | verdict | class | metric | value | platform "
             "| n_dev | world | captured rev |",
             "|---|---|---|---|---|---|---|---|---|"]
    for cid, res in sorted(report.get("records", {}).items()):
        rec = res.get("record") or {}
        topo = rec.get("topology") or {}
        rev = str(rec.get("git_rev") or "?")[:12]
        badge = {"MEASURED": "**MEASURED**", "PROJECTED": "*PROJECTED*",
                 "STALE": "~~STALE~~"}.get(res["status"], res["status"])
        val = rec.get("value")
        if isinstance(val, float):
            val = f"{val:g}"
        lines.append(
            f"| `{cid}` | {badge} | {rec.get('claim_class', '?')} "
            f"| {rec.get('metric', '?')} | {val} "
            f"| {rec.get('platform', '?')} | {rec.get('n_devices', '?')} "
            f"| {topo.get('world', '?')} | `{rev}` |")
    fails = report.get("failures") or []
    if fails:
        lines += ["", "Gate failures:", ""]
        lines += [f"- {f}" for f in fails]
    lines += ["", GATE_END]
    return "\n".join(lines)


def splice_badges(readme_path: str, report: Mapping[str, Any]) -> bool:
    """Replace (or append) the badge block between the gate fences; True
    when the file changed."""
    try:
        with open(readme_path) as f:
            text = f.read()
    except OSError:
        return False
    block = render_badges(report)
    if GATE_BEGIN in text and GATE_END in text:
        pre = text.split(GATE_BEGIN)[0]
        post = text.split(GATE_END, 1)[1]
        new = pre + block + post
    else:
        new = text.rstrip("\n") + "\n\n" + block + "\n"
    if new == text:
        return False
    tmp = readme_path + ".tmp"
    with open(tmp, "w") as f:
        f.write(new)
    os.replace(tmp, readme_path)
    return True
