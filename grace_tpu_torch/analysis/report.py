"""Rendering findings: terminal text, JSON, and telemetry JSONL;
counterpart of the JAX package's ``analysis/report.py``, in its formats.

The JSONL is what :class:`grace_tpu_torch.telemetry.JSONLSink` writes (an
optional ``{"provenance": ...}`` line, then records with an ``"event"``
key), so ``tools/telemetry_report.py`` renders the findings beside guard
trips and repairs.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

from grace_tpu_torch.analysis.passes import Finding

__all__ = ["render_text", "findings_to_json", "write_jsonl"]


def render_text(findings: Sequence[Finding], *, audited: int = 0,
                rules_checked: int = 0) -> str:
    out = []
    errors = [f for f in findings if f.severity == "error"]
    warnings = [f for f in findings if f.severity != "error"]
    for f in findings:
        loc = f.config + (f" [{f.stage}]" if f.stage else "")
        out.append(f"{f.severity.upper():7s} {f.pass_name:24s} {loc}")
        out.append(f"        {f.message}")
    out.append(
        f"graft-lint: {len(errors)} error(s), {len(warnings)} warning(s)"
        + (f" over {audited} config(s)" if audited else "")
        + (f", {rules_checked} repo rule(s)" if rules_checked else ""))
    return "\n".join(out)


def findings_to_json(findings: Sequence[Finding], *, audited: int = 0,
                     rules_checked: int = 0) -> str:
    doc = {
        "tool": "graft_lint",
        "errors": sum(1 for f in findings if f.severity == "error"),
        "warnings": sum(1 for f in findings if f.severity != "error"),
        "configs_audited": audited,
        "rules_checked": rules_checked,
        "findings": [f.as_dict() for f in findings],
    }
    return json.dumps(doc, indent=1)


def write_jsonl(findings: Sequence[Finding], path: str,
                provenance: Optional[dict] = None) -> None:
    """Append findings as ``lint_finding`` events (JSONLSink's format)."""
    with open(path, "a") as f:
        if provenance is not None:
            f.write(json.dumps({"provenance": provenance}) + "\n")
        for finding in findings:
            rec = {"event": "lint_finding", **finding.as_dict()}
            f.write(json.dumps(rec, default=str) + "\n")
