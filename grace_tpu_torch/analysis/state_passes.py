"""The three state passes (8–10); counterpart of the JAX package's
``analysis/state_passes.py``.

Passes 1–7 audit what a traced step does; these three audit what it does
to its state:

* **pass 8 ``rng_lineage``** — every random draw of the port goes through
  :class:`grace_tpu_torch.core.LeafKey`, and the tracer records each
  consumption as a ``draw`` node with its lineage: the state fields the
  key's seed and count came from (``STEP_KEY_FIELDS``, or the constants
  themselves), its leaf and its folds. Two draws of one lineage with
  different ``(method, shape, dtype)`` draw correlated noise from one
  stream: an error. The identical re-draw (the telemetry error's
  round-trip re-runs the compress under the same key) is one draw taken
  twice, and exempt. JAX exempts draws in exclusive ``cond`` arms; here
  each host branch is a trace of its own, so every pair of draws in one
  trace can co-occur. And a draw must come from a key that is the same on
  every rank: the pass compares the trace with its twin taken as rank
  W−1 (:meth:`TracedGraph.twin`); a draw whose derived seed differs
  between the two comes from a rank-varying key.

* **pass 9 ``rollback_coverage``** — the guard's atomicity contract, on
  guarded traces (``meta['guard']``): every state leaf the guarded update
  writes must come out of a bad step as it went in. The port restores by
  arithmetic, not by ``jnp.where``: the snapshot is ``_foreach_copy_``,
  the restore ``x·(1−bad) + s·bad`` over integer views
  (``_foreach_mul_``/``_foreach_add_``), the rings ``torch.where`` on the
  flag. So a device leaf is proven restored when its value after the
  step descends from a *select on the flag* (``where``, or a product with
  it) one of whose operands is a *snapshot of that same leaf* (its value
  before the step, or a copy of it), the flag descending from the
  non-finite scan (``isfinite``/``isnan``/``isinf``; the mark survives
  ``.to(int32)``, the OR all-reduce and ``1 − bad``); or when it passed
  through untouched (the same storage and write). What lives on the host
  (``count``, ``fallback``, the ladder's ints, an optimizer's host
  state) has no dataflow to follow: the tracer settles the guarded
  update's verdict twice, quietly, once read as bad and once as good
  (:func:`~grace_tpu_torch.analysis.trace.trace_train_step`'s
  ``guard_probe``), and the pass proves them from that. Read as bad,
  every host leaf must be as it was before the step (``_Pending.restores``
  and ``_Pending.adapt`` put them back; the ladder's device statistics
  come back as the step's input values); read as good, ``count`` must
  advance by one; ``fallback`` must follow the verdict's second flag
  under both; and the read flags must descend from the non-finite scan.
  Leaves whose path names a field of ``GUARD_ROLLBACK_EXCLUDED`` are
  written through by design.

* **pass 10 ``replication_contract``** — at step exit the device leaves
  of ``GRACE_REPLICATED_FIELDS`` (the ladder's statistics) must be
  replicated, by the rank-variance dataflow of pass 1
  (:func:`~grace_tpu_torch.analysis.passes.replication`); its host fields
  (``count``, ``seed``, ``fallback``, the audit's and the ladder's ints)
  must be equal in the trace and its rank-(W−1) twin, in which every host
  read of a rank-varying value got another stub, so a host field fed by
  one differs. A varying field with no leaf that varies is a warning. On
  consensus traces the replicated leaves are checked over the exchange
  axis only, as in JAX (the audit's repairs replicate by induction over
  the other axis). And :func:`_contract_drift` reconciles the four
  field-role constants with ``GraceState``'s fields, the checkpoint's
  per-rank split and ``carry_replicated`` (the port has no
  ``partition_specs``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

from grace_tpu_torch.analysis.passes import Finding, replication
from grace_tpu_torch.analysis.trace import TensorRef, TracedGraph

__all__ = ["STATE_PASS_NAMES", "PASS_FNS", "pass_rng_lineage",
           "pass_rollback_coverage", "pass_replication_contract"]

STATE_PASS_NAMES = ("rng_lineage", "rollback_coverage",
                    "replication_contract")

# Ops whose output is a copy of a source value (a snapshot keeps the
# source's leaves); for the in-place ones the source is the second
# operand, after the destination.
_COPIES = frozenset({"aten.clone.default", "aten._to_copy.default",
                     "aten.alias.default", "aten.lift_fresh.default"})
_COPY_INTO = frozenset({"aten.copy_.default", "aten._foreach_copy_.default",
                        "aten._foreach_copy.default"})
# Selects on the flag: where, or a product with the 0/1 flag.
_SELECTS = ("aten.where.", "aten.mul.", "aten.mul_.", "aten._foreach_mul")


def _is_select(name: str) -> bool:
    return name.startswith(_SELECTS)


@dataclasses.dataclass
class _Flow:
    """Per value: ``snap``, the bitmask of seeded leaves it is a copy of;
    ``gmask``, the leaves a select on the flag could restore into it;
    ``gpred``, whether it descends from the non-finite scan."""

    snap: Dict[int, int]
    gmask: Dict[int, int]
    gpred: Dict[int, bool]


def _walk(traced: TracedGraph, seeds: List[Tuple[str, object]]) -> _Flow:
    """One forward sweep over every node (the warm-up steps' too), leaf
    ``i`` of ``seeds`` seeding bit ``i`` on its value."""
    seed_bits: Dict[int, int] = {}
    for i, (_path, ref) in enumerate(seeds):
        if isinstance(ref, TensorRef):
            seed_bits[ref.vid] = seed_bits.get(ref.vid, 0) | (1 << i)
    snap = dict(seed_bits)           # seeds that no node of the trace made
    gmask: Dict[int, int] = {}
    gpred: Dict[int, bool] = {v: True for v in traced.scans}
    for node in traced.nodes:
        select = node.kind == "op" and _is_select(node.name)
        for j, v in enumerate(node.outs):
            src = node.sources(j)
            g = 0
            p = False
            for u in src:
                g |= gmask.get(u, 0)
                p = p or gpred.get(u, False)
            if select and p:
                for u in src:
                    g |= snap.get(u, 0)
            if node.name in _COPY_INTO:
                s = 0
                for u in src[1:2]:
                    s |= snap.get(u, 0)
                snap[v] = s
            elif node.name in _COPIES and src:
                snap[v] = snap.get(src[0], 0)
            else:
                snap.pop(v, None)
            if v in seed_bits:          # a warm-up step made the seed
                snap[v] = snap.get(v, 0) | seed_bits[v]
            gmask[v] = g
            gpred[v] = p or v in traced.scans
    return _Flow(snap=snap, gmask=gmask, gpred=gpred)


def _grace_field(path: str) -> Optional[str]:
    """The GraceState field a leaf path lies in (``grace/inner/mem/0``,
    ``mem/w``, ``count``), or None (parameters, optimizer state, the
    guard's counters)."""
    from grace_tpu_torch.transform import GraceState

    parts = path.split("/")
    if parts and parts[0] == "grace":
        parts = parts[1:]
    if parts and parts[0] == "inner":
        parts = parts[1:]
    names = {f.name for f in dataclasses.fields(GraceState)}
    return parts[0] if parts and parts[0] in names else None


def _twin_or_finding(traced: TracedGraph, pass_name: str):
    """``(twin, findings)``: the rank-(W−1) trace, or the error its
    failure is."""
    try:
        return traced.twin(), []
    except Exception as e:                               # noqa: BLE001
        return None, [Finding(
            pass_name=pass_name, config=traced.name, severity="error",
            message=(f"the step traced as rank {traced.n_ranks - 1} fails "
                     f"({type(e).__name__}: {e}) where rank "
                     f"{traced.rank}'s runs: a rank-varying value (a host "
                     "read of one, or the rank itself) steers it"),
            details=(("branch", traced.branch),))]


# ---------------------------------------------------------------------------
# pass 8: rng lineage
# ---------------------------------------------------------------------------

def _draw_sig(node) -> Tuple:
    a = node.attrs
    return (a["lineage"], a["method"], a["shape"], a["dtype"])


def pass_rng_lineage(traced: TracedGraph) -> List[Finding]:
    """Independent stochastic sites must draw from independent lineages,
    and every key must be the same on every rank (module docstring)."""
    findings: List[Finding] = []
    draws = traced.draws
    by_lin: Dict[Tuple, List] = {}
    for d in draws:
        by_lin.setdefault(d.attrs["lineage"], []).append(d)
    reported = set()
    for lin, group in by_lin.items():
        kinds = {}
        for d in group:
            kinds.setdefault(_draw_sig(d)[1:], d)
        if len(kinds) < 2:
            continue                    # one draw, or identical re-draws
        (ka, a), (kb, b) = list(kinds.items())[:2]
        key = (lin, ka, kb)
        if key in reported:
            continue
        reported.add(key)
        findings.append(Finding(
            pass_name="rng_lineage", config=traced.name, severity="error",
            stage=a.stage or b.stage,
            message=(
                f"two independent stochastic sites share one rng lineage "
                f"{lin}: {ka[0]} {ka[2]}{ka[1]} at '{a.stage or '?'}' and "
                f"{kb[0]} {kb[2]}{kb[1]} at '{b.stage or '?'}' draw from "
                "the same key — correlated noise breaks the unbiased-"
                "estimator contract; fold a distinct site index into each "
                "key (LeafKey.fold)"),
            details=(("lineage", lin), ("draws", (ka, kb)),
                     ("branch", traced.branch))))
    twin, failed = _twin_or_finding(traced, "rng_lineage")
    if twin is None:                    # one rank, or it failed
        return findings + failed
    other = twin.draws
    if [_draw_sig(d)[1:] for d in draws] \
            != [_draw_sig(d)[1:] for d in other]:
        findings.append(Finding(
            pass_name="rng_lineage", config=traced.name, severity="error",
            message=(
                f"rank {traced.rank} and rank {twin.rank} draw different "
                f"schedules ({len(draws)} and {len(other)} draws): the "
                "draws depend on the rank, so ranks that must agree on a "
                "random selection part"),
            details=(("branch", traced.branch),)))
        return findings
    for d, e in zip(draws, other):
        if d.attrs["derived"] != e.attrs["derived"] \
                or d.attrs["lineage"] != e.attrs["lineage"]:
            a = d.attrs
            findings.append(Finding(
                pass_name="rng_lineage", config=traced.name,
                severity="error", stage=d.stage,
                message=(
                    f"stochastic draw ({a['method']} -> "
                    f"{a['dtype']}{a['shape']}) consumes a rank-varying "
                    f"key: its seed differs between rank {traced.rank} "
                    f"and rank {twin.rank} — the step's key is replicated "
                    "so every rank draws the same schedule; a per-rank "
                    "key desyncs rank-deterministic selection (cyclictopk "
                    "rotation, shared Top-K negotiation)"),
                details=(("lineage", a["lineage"]), ("shape", a["shape"]),
                         ("branch", traced.branch))))
    return findings


# ---------------------------------------------------------------------------
# pass 9: rollback coverage
# ---------------------------------------------------------------------------

def pass_rollback_coverage(traced: TracedGraph) -> List[Finding]:
    """Every state leaf the guarded update writes must be restored on a
    bad step, or be declared written through (module docstring). Only
    guarded traces (``meta['guard']``) have the contract."""
    if traced.meta.get("guard") is None:
        return []
    from grace_tpu_torch.resilience.guard import GUARD_ROLLBACK_EXCLUDED

    probe = traced.guard_probe
    before = probe["in"] if probe else traced.leaves_in
    after = dict(probe["bad"] if probe else traced.leaves_out)
    if not before or not after:
        return []
    flow = _walk(traced, before)
    excluded = set(GUARD_ROLLBACK_EXCLUDED)
    findings: List[Finding] = []

    def error(message, path):
        findings.append(Finding(
            pass_name="rollback_coverage", config=traced.name,
            severity="error", message=message,
            details=(("path", path), ("branch", traced.branch))))

    for i, (path, ref) in enumerate(before):
        out = after.get(path)
        if out is None or out == ref:
            continue                    # passed through, or put back
        if set(path.split("/")) & excluded:
            continue                    # declared written-through
        if isinstance(out, TensorRef) and isinstance(ref, TensorRef):
            if flow.gmask.get(out.vid, 0) & (1 << i):
                continue                # restored by a select on the flag
            error(f"state leaf '{path}' is written by the guarded step but "
                  "never restored by a select on the guard's flag from its "
                  "own snapshot: on a bad step its new (possibly poisoned) "
                  "value survives. Route it through the guard's snapshot "
                  "and restore, or — if it is deliberately written through "
                  "— add its field to "
                  "resilience.guard.GUARD_ROLLBACK_EXCLUDED", path)
        else:
            error(f"host state leaf '{path}' is {out!r} after a bad step "
                  f"where it was {ref!r}: the guard's settle must put it "
                  "back (_Pending.restores, _Pending.adapt) or its field "
                  "be declared in GUARD_ROLLBACK_EXCLUDED", path)
    if probe:
        findings += _verdict_findings(traced, probe, flow)
    return findings


def _verdict_findings(traced, probe, flow: _Flow) -> List[Finding]:
    """The host-held ``count`` and ``fallback`` against the two settled
    verdicts, and the verdict's descent from the non-finite scan."""
    out: List[Finding] = []

    def error(message):
        out.append(Finding(pass_name="rollback_coverage",
                           config=traced.name, severity="error",
                           message=message,
                           details=(("branch", traced.branch),)))

    def field(label, name):
        for path, value in probe[label]:
            if _grace_field(path) == name and path.endswith("/" + name):
                return value
        return None

    before, good = field("in", "count"), field("good", "count")
    if before is not None and good != before + 1:
        error(f"count reads {good} after an accepted step from {before}: "
              "the guard's settle must advance it exactly then")
    for label, want in (("bad", False), ("good", True)):
        got = field(label, "fallback")       # the probes' second flags
        if got is not None and bool(got) != want:
            error(f"fallback reads {got} where the guard's verdict read "
                  f"{int(want)}: the settle must take the flag from the "
                  "verdict")
    if not flow.gpred.get(probe["flags"], False):
        error("the guard's [bad, fallback] verdict does not descend from "
              "the step's non-finite scan: a settle on it restores "
              "nothing the scan found")
    return out


# ---------------------------------------------------------------------------
# pass 10: replication contract
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _contract_drift() -> Tuple[str, ...]:
    """The four field-role constants reconciled with ``GraceState``'s
    fields, the checkpoint's per-rank split and ``carry_replicated``.
    Config-independent, computed once per process."""
    from grace_tpu_torch import checkpoint
    from grace_tpu_torch import transform as T

    msgs: List[str] = []
    fields = [f.name for f in dataclasses.fields(T.GraceState)]
    roles = {"GRACE_VARYING_FIELDS": set(T.GRACE_VARYING_FIELDS),
             "GRACE_REPLICATED_FIELDS": set(T.GRACE_REPLICATED_FIELDS),
             "GRACE_HOST_FIELDS": set(T.GRACE_HOST_FIELDS)}
    names = list(roles)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            both = roles[a] & roles[b]
            if both:
                msgs.append(f"fields {sorted(both)} appear in both {a} and "
                            f"{b}")
    named = set().union(*roles.values())
    missing = [f for f in fields if f not in named]
    if missing:
        msgs.append(f"GraceState fields {missing} appear in none of "
                    f"{', '.join(names)} — extend one of the constants")
    ghost = named - set(fields)
    if ghost:
        msgs.append(f"field-role constants name {sorted(ghost)}, which "
                    "are not GraceState fields")
    if not set(T.GRACE_OBSERVATIONAL_FIELDS) <= roles[names[0]]:
        msgs.append("GRACE_OBSERVATIONAL_FIELDS is not a subset of "
                    "GRACE_VARYING_FIELDS")
    if msgs:
        return tuple(msgs)
    old = T.GraceState(**{f: ("old", f) for f in fields})
    fresh = T.GraceState(**{f: ("fresh", f) for f in fields})
    # The checkpoint writes varying fields a file a rank, the rest once,
    # and host bookkeeping not at all.
    split = {name: varying
             for name, _leaf, varying in checkpoint._node_children(old)}
    for f in fields:
        if f in roles["GRACE_HOST_FIELDS"]:
            if f in split:
                msgs.append(f"the checkpoint stores host field '{f}'")
        elif f not in split:
            msgs.append(f"the checkpoint leaves out field '{f}'")
        elif split[f] != (f in roles["GRACE_VARYING_FIELDS"]):
            msgs.append(
                f"the checkpoint writes field '{f}' "
                f"{'per rank' if split[f] else 'once'}, but its role says "
                f"{'per rank' if not split[f] else 'once'}")
    # A resize carries the replicated fields and keeps the fresh rest.
    carried = T.carry_replicated(old, fresh)
    for f in fields:
        want = "old" if f in roles["GRACE_REPLICATED_FIELDS"] else "fresh"
        got = getattr(carried, f)[0]
        if got != want:
            msgs.append(f"carry_replicated takes field '{f}' from the "
                        f"{got} state, but its role says the {want} one")
    return tuple(msgs)


def pass_replication_contract(traced: TracedGraph) -> List[Finding]:
    """At step exit the replicated fields must be provably replicated,
    the varying ones should vary, and the field-role constants must agree
    with every layout consumer (module docstring)."""
    from grace_tpu_torch.transform import (GRACE_REPLICATED_FIELDS,
                                           GRACE_VARYING_FIELDS)

    findings = [Finding(pass_name="replication_contract",
                        config=traced.name, severity="error", message=m)
                for m in _contract_drift()]
    if not traced.leaves_out:
        return findings
    var = replication(traced)
    axes = traced.axes
    check = ((traced.axis_name,) if traced.meta.get("consensus")
             else axes)
    field_var: Dict[Tuple[str, str], set] = {}
    host: Dict[str, object] = {}
    for path, ref in traced.leaves_out:
        field = _grace_field(path)
        if field is None:
            continue
        if not isinstance(ref, TensorRef):
            if field in GRACE_REPLICATED_FIELDS:
                host[path] = ref
            continue
        varies = {a for a in axes if var[a].get(ref.vid, False)}
        bad = [a for a in check if a in varies]
        if field in GRACE_REPLICATED_FIELDS and bad:
            findings.append(Finding(
                pass_name="replication_contract", config=traced.name,
                severity="error",
                message=(
                    f"replicated-field leaf '{path}' leaves the step "
                    f"rank-varying over {', '.join(bad)} — a rank-varying "
                    "write into a GRACE_REPLICATED_FIELDS field desyncs "
                    "replicas (the adapt-rung desync class); make the "
                    "write derive from full-axis collectives, or move the "
                    "field to GRACE_VARYING_FIELDS"),
                details=(("path", path), ("axes", tuple(bad)),
                         ("branch", traced.branch))))
        if field in GRACE_VARYING_FIELDS:
            key = (path.rsplit(field, 1)[0], field)
            field_var.setdefault(key, set()).update(varies)
    for (_prefix, field), varies in sorted(field_var.items()):
        missing = [a for a in axes if a not in varies]
        if missing:
            findings.append(Finding(
                pass_name="replication_contract", config=traced.name,
                severity="warning",
                message=(
                    f"varying field '{field}' has no leaf that actually "
                    f"varies over {', '.join(missing)} — each rank keeps "
                    "its own copy, but it is provably the same on every "
                    "rank; either the state is dead weight at world size "
                    "or the field belongs in GRACE_REPLICATED_FIELDS"),
                details=(("field", field), ("axes", tuple(missing)))))
    if not host:
        return findings
    twin, failed = _twin_or_finding(traced, "replication_contract")
    if twin is None:
        return findings + failed
    theirs = dict(twin.leaves_out)
    for path, value in host.items():
        other = theirs.get(path)
        if other != value:
            findings.append(Finding(
                pass_name="replication_contract", config=traced.name,
                severity="error",
                message=(
                    f"replicated host field '{path}' leaves the step as "
                    f"{value!r} on rank {traced.rank} and {other!r} on rank "
                    f"{twin.rank}: it is written from the rank, or from a "
                    "host read of a rank-varying value — every rank must "
                    "compute it from replicated inputs"),
                details=(("path", path), ("branch", traced.branch))))
    return findings


PASS_FNS = {
    "rng_lineage": pass_rng_lineage,
    "rollback_coverage": pass_rollback_coverage,
    "replication_contract": pass_replication_contract,
}
