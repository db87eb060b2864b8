"""The one staleness detector; counterpart of the JAX package's
``evidence/staleness.py``.

Feature-stamp checks on an evidence document, plus the git-ancestry check:
the provenance rev must be an ancestor of HEAD (``git merge-base
--is-ancestor``), or the capture was taken on a branch or before a
rewrite whose numbers this tree never saw.

Two policies on one primitive (:func:`ancestor_verdict`):

* :func:`evidence_staleness` (documents): an ancestry reason only for a
  definite non-ancestor. An unresolvable rev (a shallow clone, a document
  copied from another checkout) is no evidence of staleness.
* the claim gate (:mod:`~grace_tpu_torch.evidence.gate`): strict, a cited
  record whose rev cannot be proven an ancestor renders STALE.
"""

from __future__ import annotations

import subprocess
from typing import Any, List, Mapping, Optional

from grace_tpu_torch.evidence.ledger import git_env, git_head_rev, repo_root

__all__ = ["STALE_BANNER", "ancestor_verdict", "evidence_staleness",
           "feature_staleness", "ancestry_staleness", "head_rev"]

STALE_BANNER = "STALE — predates PRs 7–10"

head_rev = git_head_rev        # re-export under the reader-facing name


def ancestor_verdict(rev: Optional[str], root: Optional[str] = None,
                     head: str = "HEAD") -> str:
    """``git merge-base --is-ancestor rev head`` → one of:

    * ``"ancestor"``: rev is reachable from ``head`` (exit 0);
    * ``"not_ancestor"``: both commits exist, rev is not reachable (exit 1);
    * ``"unknown"``: rev does not resolve here (exit 128 etc.), or the tree
      is no checkout;
    * ``"no_git"``: no git program at all.
    """
    if not rev:
        return "unknown"
    root = root or repo_root()
    try:
        out = subprocess.run(
            ["git", "merge-base", "--is-ancestor", str(rev), head],
            cwd=root, env=git_env(root), capture_output=True, timeout=10)
    except Exception:
        return "no_git"
    if out.returncode == 0:
        return "ancestor"
    if out.returncode == 1:
        return "not_ancestor"
    return "unknown"


def feature_staleness(doc: Any) -> List[str]:
    """Why a persisted benchmark document predates the current feature set,
    by the JAX package's stamps (its detectors, on documents in its
    schema): a document-level ``provenance`` block with
    ``pallas_enabled``/``fusion``, a ``fusion`` key on measured rows, and a
    hierarchical row in a sweep."""
    if not isinstance(doc, Mapping):
        return []
    reasons = []
    prov = doc.get("provenance")
    if not isinstance(prov, Mapping):
        reasons.append(
            "no run_provenance block — the capture predates the "
            "document-level provenance stamp (git commit unknown)")
    elif "pallas_enabled" not in prov or "fusion" not in prov:
        reasons.append(
            "provenance lacks the pallas_enabled/fusion stamps (PR 10): "
            "the headline cannot say which executor/kernel path it "
            "measured")
    rows = [r for r in (doc.get("rows") or [])
            if isinstance(r, Mapping) and r.get("config")]
    measured = [r for r in rows if "imgs_per_sec" in r
                or "tokens_per_sec" in r]
    if measured and not any("fusion" in r for r in measured):
        reasons.append(
            "rows predate the first-class fusion row stamp (PR 10)")
    if len(measured) > 2:        # a sweep, not the 2-row headline pair
        comms = {(r.get("grace_params") or {}).get("communicator")
                 for r in measured}
        if not comms & {"hier", "hierarchical", "hier_allreduce"}:
            reasons.append(
                "no hierarchical (ICI×DCN) row — the sweep predates PR 7; "
                "refresh with `bench_all --tuned`")
    return reasons


def ancestry_staleness(rev: Optional[str],
                       root: Optional[str] = None) -> List[str]:
    """Document-policy ancestry reasons: a definite non-ancestor only."""
    if ancestor_verdict(rev, root) == "not_ancestor":
        return [f"provenance rev {rev} is not an ancestor of HEAD — the "
                "capture predates a history rewrite or was taken on "
                "another branch"]
    return []


def evidence_staleness(doc: Any, root: Optional[str] = None) -> List[str]:
    """Feature stamps plus a definite-non-ancestor provenance rev; an empty
    list means current. A stale document is still evidence of the state
    at its capture, but not of the current system."""
    reasons = feature_staleness(doc)
    if isinstance(doc, Mapping):
        prov = doc.get("provenance")
        if isinstance(prov, Mapping):
            reasons += ancestry_staleness(prov.get("git_commit"), root)
    return reasons
