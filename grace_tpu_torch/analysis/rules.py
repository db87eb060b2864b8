"""AST repo rules over the port's own source; counterpart of the JAX
package's ``analysis/rules.py``, with its four rules under their names.

The passes audit traced behaviour; these rules audit source, contracts a
new contribution must state where it is written:

* ``compressor-capabilities`` — every ``Compressor`` subclass under
  ``grace_tpu_torch/compressors/`` declares ``payload_algebra`` and
  ``supports_hop_requant`` in its own class body: they are the
  communicator compatibility matrix (``Allreduce``, the ring, hier and
  the reduce-scatter dispatch on the algebra; ``summable_payload``
  derives from it), and an inherited default is silently wrong for a new
  linear or homomorphic codec;
* ``telemetry-fields-reducer`` — every ``FIELDS`` entry of
  ``grace_tpu_torch/telemetry/state.py`` names a reducer of the known set
  (the reader aggregates the ranks' rows by that string);
* ``pytest-marker-registration`` — every ``pytest.mark.<name>`` of the
  port's tests (``tests/test_torch_*.py``) is registered in
  ``pyproject.toml`` (pytest only warns on an unknown marker, so a typo
  drops tests from ``-m`` selections);
* ``grace-state-field-roles`` — every field of the ``GraceState`` class
  body (``grace_tpu_torch/transform.py``) appears in exactly one of
  ``GRACE_VARYING_FIELDS``, ``GRACE_REPLICATED_FIELDS`` and
  ``GRACE_HOST_FIELDS`` (the port's third role: host bookkeeping that no
  checkpoint stores), and every name they hold is a field. The
  checkpoint's per-rank split, ``carry_replicated``, the guard's rollback
  and the replication pass read those constants.

``run_repo_rules(sources=...)`` takes an in-memory ``{relpath: source}``
override, so that seeded bad sources prove each rule fires without
touching the tree.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional

from grace_tpu_torch.analysis.passes import Finding

__all__ = ["RULE_NAMES", "run_repo_rules", "repo_root",
           "registered_markers"]

RULE_NAMES = ("compressor-capabilities", "telemetry-fields-reducer",
              "pytest-marker-registration", "grace-state-field-roles")

_PACKAGE = "grace_tpu_torch"
_REQUIRED_CAPS = ("payload_algebra", "supports_hop_requant")
_KNOWN_REDUCERS = {"first", "mean", "max", "min", "sum"}
# Markers pytest ships (or plugins the repo uses): never registered.
_BUILTIN_MARKS = {"parametrize", "skip", "skipif", "xfail", "usefixtures",
                  "filterwarnings", "timeout", "tryfirst", "trylast",
                  "no_cover", "anyio", "asyncio"}
# The field-role constants, in the order a field is looked up.
_ROLES = ("GRACE_VARYING_FIELDS", "GRACE_REPLICATED_FIELDS",
          "GRACE_HOST_FIELDS")


def repo_root() -> str:
    """The checkout: the parent of the ``grace_tpu_torch`` package."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(here)


def _read(root: str, rel: str,
          sources: Optional[Dict[str, str]]) -> Optional[str]:
    if sources is not None and rel in sources:
        return sources[rel]
    try:
        with open(os.path.join(root, rel)) as f:
            return f.read()
    except OSError:
        return None


def _iter_py(root: str, reldir: str, sources: Optional[Dict[str, str]],
             prefix: str = "") -> List[str]:
    """Relative paths of the ``.py`` files under ``reldir`` whose names
    start with ``prefix``, and of any in-memory overrides there."""
    rels = []
    absdir = os.path.join(root, reldir)
    if os.path.isdir(absdir):
        for dirpath, _dirs, files in os.walk(absdir):
            for fn in sorted(files):
                if fn.endswith(".py") and fn.startswith(prefix):
                    rels.append(os.path.relpath(os.path.join(dirpath, fn),
                                                root))
    for rel in sources or ():
        if rel.startswith(reldir + os.sep) and rel.endswith(".py") \
                and os.path.basename(rel).startswith(prefix) \
                and rel not in rels:
            rels.append(rel)
    return rels


def _class_assigns(cls: ast.ClassDef) -> set:
    names = set()
    for node in cls.body:
        if isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return names


def _base_names(cls: ast.ClassDef) -> List[str]:
    return [b.id if isinstance(b, ast.Name) else b.attr
            for b in cls.bases if isinstance(b, (ast.Name, ast.Attribute))]


def rule_compressor_capabilities(root: str, sources=None) -> List[Finding]:
    findings: List[Finding] = []
    for rel in _iter_py(root, os.path.join(_PACKAGE, "compressors"),
                        sources):
        src = _read(root, rel, sources)
        if src is None:
            continue
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            findings.append(Finding(
                pass_name="compressor-capabilities", config=rel,
                severity="error", message=f"unparseable source: {e}"))
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef) \
                    or not any(b.endswith("Compressor")
                               for b in _base_names(node)):
                continue
            missing = [c for c in _REQUIRED_CAPS
                       if c not in _class_assigns(node)]
            if missing:
                findings.append(Finding(
                    pass_name="compressor-capabilities",
                    config=f"{rel}:{node.lineno}", severity="error",
                    message=(
                        f"{node.name} does not declare "
                        f"{'/'.join(missing)} in its class body — these "
                        "declarations ARE the communicator compatibility "
                        "matrix (payload_algebra selects the payload-space "
                        "accumulation path: exact/shared_scale/sketch/"
                        "None, from which summable_payload derives; "
                        "supports_hop_requant opts into the ring's per-hop "
                        "requantization); state them explicitly even when "
                        "None/False so the contract is visible at the "
                        "definition site"),
                    details=(("class", node.name),)))
    return findings


def rule_telemetry_fields(root: str, sources=None) -> List[Finding]:
    rel = os.path.join(_PACKAGE, "telemetry", "state.py")
    src = _read(root, rel, sources)
    if src is None:
        return [Finding(pass_name="telemetry-fields-reducer", config=rel,
                        severity="error", message="state.py not found")]
    fields_node = None
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "FIELDS"
                for t in node.targets):
            fields_node = node.value
    if not isinstance(fields_node, (ast.Tuple, ast.List)):
        return [Finding(pass_name="telemetry-fields-reducer", config=rel,
                        severity="error",
                        message="FIELDS tuple literal not found")]
    findings: List[Finding] = []
    for i, elt in enumerate(fields_node.elts):
        if not (isinstance(elt, ast.Tuple) and len(elt.elts) == 2
                and all(isinstance(e, ast.Constant)
                        and isinstance(e.value, str) for e in elt.elts)):
            findings.append(Finding(
                pass_name="telemetry-fields-reducer",
                config=f"{rel}:{elt.lineno}", severity="error",
                message=(f"FIELDS[{i}] is not a (name, reducer) string "
                         "pair — the reader aggregates the ranks' rows by "
                         "the reducer string")))
            continue
        name, reducer = (e.value for e in elt.elts)
        if reducer not in _KNOWN_REDUCERS:
            findings.append(Finding(
                pass_name="telemetry-fields-reducer",
                config=f"{rel}:{elt.lineno}", severity="error",
                message=(f"FIELDS entry {name!r} names unknown reducer "
                         f"{reducer!r} (known: {sorted(_KNOWN_REDUCERS)}) "
                         "— the host-side cross-rank aggregation would "
                         "silently fall through"),
                details=(("field", name),)))
    return findings


def registered_markers(root: str, sources=None) -> set:
    """Marker names registered in ``pyproject.toml``: the quoted strings
    of its ``markers = [...]`` array, each up to its colon."""
    src = _read(root, "pyproject.toml", sources)
    m = re.search(r"markers\s*=\s*\[(.*?)\]", src or "", re.DOTALL)
    if not m:
        return set()
    return {entry.split(":")[0].strip()
            for entry in re.findall(r"[\"']([^\"']+)[\"']", m.group(1))}


def rule_pytest_markers(root: str, sources=None) -> List[Finding]:
    registered = registered_markers(root, sources) | _BUILTIN_MARKS
    findings: List[Finding] = []
    for rel in _iter_py(root, "tests", sources, prefix="test_torch_"):
        src = _read(root, rel, sources)
        if src is None:
            continue
        try:
            tree = ast.parse(src)
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            # pytest.mark.<name>: an attribute chain rooted at pytest.
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Attribute)
                    and node.value.attr == "mark"
                    and isinstance(node.value.value, ast.Name)
                    and node.value.value.id == "pytest"
                    and node.attr not in registered):
                findings.append(Finding(
                    pass_name="pytest-marker-registration",
                    config=f"{rel}:{node.lineno}", severity="error",
                    message=(
                        f"pytest marker {node.attr!r} is not registered "
                        "in pyproject.toml [tool.pytest.ini_options] "
                        "markers — pytest only warns on unknown markers, so "
                        f"'-m {node.attr}' selections silently go empty on "
                        "a typo"),
                    details=(("marker", node.attr),)))
    return findings


def _tuple_literal(tree: ast.Module, name: str) -> Optional[set]:
    """The strings of a module-level ``name = ("a", "b", ...)``, or None
    when absent or not a literal."""
    for node in tree.body:
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, (ast.Tuple, ast.List)) \
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets):
            elts = node.value.elts
            if all(isinstance(e, ast.Constant) and isinstance(e.value, str)
                   for e in elts):
                return {e.value for e in elts}
    return None


def rule_grace_state_field_roles(root: str, sources=None) -> List[Finding]:
    rel = os.path.join(_PACKAGE, "transform.py")

    def finding(message, config=rel, field=None):
        return Finding(pass_name="grace-state-field-roles", config=config,
                       severity="error", message=message,
                       details=(("field", field),) if field else ())

    src = _read(root, rel, sources)
    if src is None:
        return [finding("transform.py not found")]
    tree = ast.parse(src)
    cls = next((n for n in ast.walk(tree)
                if isinstance(n, ast.ClassDef) and n.name == "GraceState"),
               None)
    if cls is None:
        return [finding("GraceState class not found")]
    roles = {name: _tuple_literal(tree, name) for name in _ROLES}
    missing = [name for name, v in roles.items() if v is None]
    if missing:
        return [finding(f"{'/'.join(missing)} string-tuple literal not "
                        "found in transform.py — the field-role constants "
                        "must stay statically readable")]
    # The class body's annotated assignments: a new field is caught before
    # it is ever traced.
    fields = [n.target.id for n in cls.body
              if isinstance(n, ast.AnnAssign)
              and isinstance(n.target, ast.Name)]
    where = f"{rel}:{cls.lineno}"
    findings: List[Finding] = []
    for f in fields:
        held = [name for name, names in roles.items() if f in names]
        if not held:
            findings.append(finding(
                f"GraceState field {f!r} appears in none of "
                f"{', '.join(_ROLES)} — add it to GRACE_VARYING_FIELDS "
                "(per-rank data: a checkpoint file a rank, re-initialized "
                "on an elastic resize), GRACE_REPLICATED_FIELDS "
                "(bit-identical across ranks, carried through a resize) or "
                "GRACE_HOST_FIELDS (host bookkeeping no checkpoint "
                "stores); without a role the field gets no layout, no "
                "rollback audit and no replication check", where, f))
        elif len(held) > 1:
            findings.append(finding(
                f"GraceState field {f!r} appears in {' and '.join(held)} "
                "— the roles are exclusive", where, f))
    for f in sorted(set().union(*roles.values()) - set(fields)):
        findings.append(finding(
            f"field-role constants name {f!r}, which is not a GraceState "
            "field — stale entry after a rename?", rel, f))
    return findings


_RULE_FNS = {
    "compressor-capabilities": rule_compressor_capabilities,
    "telemetry-fields-reducer": rule_telemetry_fields,
    "pytest-marker-registration": rule_pytest_markers,
    "grace-state-field-roles": rule_grace_state_field_roles,
}


def run_repo_rules(root: Optional[str] = None, *, rules=None,
                   sources: Optional[Dict[str, str]] = None
                   ) -> List[Finding]:
    """Run the named AST rules (default: all four) over the checkout at
    ``root`` (default: this one), ``sources`` overriding files by path."""
    root = root or repo_root()
    out: List[Finding] = []
    for name in (rules if rules is not None else RULE_NAMES):
        out.extend(_RULE_FNS[name](root, sources))
    return out
