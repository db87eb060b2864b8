"""The port's state passes (``rng_lineage``, ``rollback_coverage``,
``replication_contract``) and AST repo rules, on the CPU.

The JAX package's ``tests/test_state_passes.py`` in the port's form: each
pass fires on a deliberately bad step of the port and stays quiet on its
clean twin, the field-role constants agree with every consumer, and the
four repo rules are clean on the port's tree and fire on seeded bad
sources (with ``tests/test_analysis.py``'s rule cases). The registry's
ten-pass audit against the JAX package is ``test_torch_analysis.py``'s and
``test_torch_flow.py``'s. Where the JAX package has the same hazard, its
own passes are run on it too, and both verdicts must agree.
"""

import dataclasses
import json
import os

import pytest
import torch
import torch.distributed as dist

from grace_tpu_torch import core
from grace_tpu_torch.analysis import (AUDIT_CONFIGS, PASS_NAMES, Branch,
                                      fake_world, run_passes, trace_fn,
                                      trace_update)
from grace_tpu_torch.analysis.__main__ import main as cli
from grace_tpu_torch.analysis.configs import trace_config
from grace_tpu_torch.analysis.rules import (RULE_NAMES, registered_markers,
                                            repo_root, run_repo_rules)
from grace_tpu_torch.analysis.state_passes import (_contract_drift,
                                                   pass_replication_contract,
                                                   pass_rng_lineage,
                                                   pass_rollback_coverage)
from grace_tpu_torch.analysis.trace import TensorRef
from grace_tpu_torch.core import STEP_KEY_FIELDS, LeafKey
from grace_tpu_torch.resilience import guard as G
from grace_tpu_torch.transform import (GRACE_HOST_FIELDS,
                                       GRACE_OBSERVATIONAL_FIELDS,
                                       GRACE_REPLICATED_FIELDS,
                                       GRACE_VARYING_FIELDS, GraceState)

pytestmark = pytest.mark.analysis

ROUTES = ("cpu", "cuda")
F8 = ((8,), torch.float32)
F4 = ((4,), torch.float32)
F0 = ((), torch.float32)
I32 = ((), torch.int32)
KEY = LeafKey(0, 0, 3, fields=STEP_KEY_FIELDS)
GUARD = {"guard": {"fallback_after": 3, "fallback_steps": 8}}


def _rng(fn, args, name, device="cuda", **kw):
    return trace_fn(fn, args, name=name, device=device, **kw)


# ---------------------------------------------------------------------------
# the record: draws, ranks, identities, edges
# ---------------------------------------------------------------------------

def test_draws_are_recorded_with_their_lineage():
    def fn(w):
        w.add_(KEY.fold(2).uniform(w.shape, w.device))
        KEY.seed_int32()

    t = _rng(fn, [F8], "draws")
    d = [(n.attrs["method"], n.attrs["shape"], n.attrs["lineage"])
         for n in t.draws]
    assert d == [("uniform", (8,), ("fields", "seed", "count",
                                     ("leaf", 3), ("folds", (2,)))),
                 ("seed_int32", (), ("fields", "seed", "count",
                                     ("leaf", 3), ("folds", ())))]
    assert t.draws[0].attrs["derived"] == KEY.fold(2).derived_seed()
    # Outside a trace a draw notes nothing: the recorder is unset.
    assert core.DRAW_RECORDER is None
    KEY.uniform((2,), "cpu")


def test_step_keys_name_the_state_fields():
    t = trace_update({"compressor": "qsgd", "quantum_num": 64,
                      "use_pallas": False, "memory": "none",
                      "communicator": "allgather"}, device="cpu")
    assert [n.attrs["fields"] for n in t.draws] == [STEP_KEY_FIELDS] * 2
    assert [n.attrs["lineage"][3] for n in t.draws] \
        == [("leaf", 0), ("leaf", 1)]


def test_fake_world_takes_any_rank():
    with fake_world(8, rank=5):
        assert dist.get_rank() == 5 and dist.get_world_size() == 8
    with pytest.raises(ValueError, match="not in a world"):
        with fake_world(4, rank=4):
            pass
    assert not dist.is_initialized()


def test_twin_is_the_last_rank():
    t = trace_fn(lambda x: x.add_(dist.get_rank()), [F8], name="twin")
    twin = t.twin()
    assert (t.rank, twin.rank) == (0, 7) and twin.twin() is not None
    assert t.twin() is twin                 # made once
    assert trace_fn(lambda x: x, [F8], world=1).twin() is None


@pytest.mark.parametrize("device", ROUTES)
def test_leaf_identity_tells_passthrough_inplace_and_replaced(device):
    def fn(keep, inplace, replaced):
        inplace.add_(1.0)
        return keep, inplace, replaced * 2.0

    t = trace_fn(fn, [F8, F8, F8], state=("a", "b", "c"), device=device)
    ins, outs = dict(t.leaves_in), dict(t.leaves_out)
    assert outs["a"] == ins["a"]
    assert outs["b"].storage == ins["b"].storage \
        and outs["b"].vid != ins["b"].vid
    assert outs["c"].storage != ins["c"].storage
    assert all(isinstance(r, TensorRef) for r in outs.values())


def test_foreach_ops_make_one_edge_per_element():
    def fn(a, b, c, d):
        torch._foreach_add_([a, b], [c, d])

    t = trace_fn(fn, [F8, F8, F8, F8])
    node = next(n for n in t.nodes if n.name == "aten._foreach_add_.List")
    a, b, c, d = t.grad_in
    assert node.sources(0) == (a, c) and node.sources(1) == (b, d)
    assert set(node.ins) == {a, b, c, d}


# ---------------------------------------------------------------------------
# pass 8: rng lineage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ROUTES)
def test_rng_lineage_fires_on_shared_lineage(device):
    """Two independent stochastic sites (different draw shapes) consuming
    the same derived key: the correlated-noise bug."""
    def bad(w, b):
        k = KEY.fold(7)
        w.add_(k.uniform(w.shape, w.device))
        b.add_(k.uniform(b.shape, b.device))

    findings = pass_rng_lineage(_rng(bad, [F8, F4], "rng-reuse", device))
    assert len(findings) == 1 and findings[0].severity == "error"
    assert "share one rng lineage" in findings[0].message


@pytest.mark.parametrize("device", ROUTES)
def test_rng_lineage_exempts_identical_redraw(device):
    """The telemetry round-trip idiom: the same draw taken twice."""
    def ok(w):
        k = KEY.fold(3)
        w.mul_(k.uniform(w.shape, w.device) * k.uniform(w.shape, w.device))

    t = _rng(ok, [F8], "rng-probe", device)
    assert len(t.draws) == 2 and pass_rng_lineage(t) == []


def test_rng_lineage_fires_on_two_methods_of_one_key():
    """A uniform and a normal draw of one key share one generator's
    stream: not an identical re-draw, though their shape and dtype agree
    (the port compares the method too)."""
    def bad(w):
        k = KEY.fold(4)
        w.add_(k.uniform(w.shape, w.device) + k.normal(w.shape, w.device))

    findings = pass_rng_lineage(_rng(bad, [F8], "rng-methods"))
    assert len(findings) == 1 and "uniform" in findings[0].message \
        and "normal" in findings[0].message


@pytest.mark.parametrize("device", ROUTES)
def test_rng_lineage_blesses_distinct_folds(device):
    def ok(w, b):
        w.add_(KEY.fold(0).uniform(w.shape, w.device))
        b.add_(KEY.fold(1).uniform(b.shape, b.device))

    assert pass_rng_lineage(_rng(ok, [F8, F4], "rng-folds", device)) == []


def test_rng_lineage_exempts_exclusive_branches():
    """Each host branch is a trace of its own: the two arms draw
    different shapes of one lineage, and neither trace pairs them."""
    def ok(w, p):
        k = KEY.fold(5)
        n = 8 if p.item() else 4
        w[:n].add_(k.uniform((n,), w.device))

    traces = [trace_fn(ok, [F8, ((), torch.bool)], varying=[True, False],
                       name="rng-branches",
                       branch=Branch(label=str(v), reads=lambda r, v=v: v))
              for v in (True, False)]
    a, b = (t.draws[0].attrs for t in traces)
    assert a["lineage"] == b["lineage"] and a["shape"] != b["shape"]
    assert [pass_rng_lineage(t) for t in traces] == [[], []]


@pytest.mark.parametrize("device", ROUTES)
def test_rng_lineage_fires_on_rank_varying_key(device):
    """A key folded with the rank draws a different schedule a rank:
    rank-deterministic selection (cyclictopk, shared Top-K) desyncs."""
    def bad(w):
        w.add_(KEY.fold(dist.get_rank()).uniform(w.shape, w.device))

    findings = pass_rng_lineage(_rng(bad, [F8], "rng-varying", device))
    assert len(findings) == 1 and findings[0].severity == "error"
    assert "rank-varying key" in findings[0].message


def test_rng_lineage_fires_on_rank_dependent_schedule():
    def bad(w):
        if dist.get_rank():
            w.add_(KEY.uniform(w.shape, w.device))

    findings = pass_rng_lineage(_rng(bad, [F8], "rng-schedule"))
    assert findings and "draw different schedules" in findings[0].message


# ---------------------------------------------------------------------------
# pass 9: rollback coverage
# ---------------------------------------------------------------------------

def _guarded(fn, args, paths, varying, name, device="cuda"):
    return trace_fn(fn, args, varying=varying, name=name, meta=GUARD,
                    state=paths, device=device)


@pytest.mark.parametrize("device", ROUTES)
def test_rollback_coverage_fires_on_unrolled_leaf(device):
    """A state leaf written without a restore gated on the flag: the
    new-field-skips-rollback bug, found at trace time."""
    def bad(count, mem, extra, g):
        nf = ~torch.isfinite(g).all()
        return (torch.where(nf, count, count + 1),
                torch.where(nf, mem, mem + g),
                extra + 1.0)                    # skips the rollback

    t = _guarded(bad, [I32, F8, F8, F8], ("count", "mem/w", "extra"),
                 [False, True, True, True], "rollback-miss", device)
    findings = pass_rollback_coverage(t)
    assert len(findings) == 1, findings
    assert "'extra'" in findings[0].message
    assert findings[0].severity == "error"


@pytest.mark.parametrize("device", ROUTES)
def test_rollback_coverage_clean_when_all_leaves_restored(device):
    def ok(count, mem, extra, g):
        nf = ~torch.isfinite(g).all()
        return (torch.where(nf, count, count + 1),
                torch.where(nf, mem, mem + g),
                torch.where(nf, extra, extra + 1.0))

    t = _guarded(ok, [I32, F8, F8, F8], ("count", "mem/w", "extra"),
                 [False, True, True, True], "rollback-ok", device)
    assert pass_rollback_coverage(t) == []


def _bitwise_restore(mem, extra, g, wiring):
    """The guard's idiom in place: snapshot, write, then ``x·(1−bad) +
    s·bad`` over integer views, the snapshots wired to the leaves by
    ``wiring``."""
    snaps = [torch.empty_like(mem), torch.empty_like(extra)]
    torch._foreach_copy_(snaps, [mem, extra])
    mem.add_(g)
    extra.add_(1.0)
    bad = (~torch.isfinite(g).all()).to(torch.int32)
    bits = [s.view(torch.int32) for s in snaps]
    ints = [mem.view(torch.int32), extra.view(torch.int32)]
    torch._foreach_mul_(bits, bad)
    torch._foreach_mul_(ints, 1 - bad)
    torch._foreach_add_(ints, [bits[i] for i in wiring])


@pytest.mark.parametrize("device", ROUTES)
def test_rollback_coverage_follows_the_bitwise_restore(device):
    """The port's restore: one edge a list element, so a leaf restored
    from another leaf's snapshot is not restored."""
    t = _guarded(lambda m, e, g: _bitwise_restore(m, e, g, (0, 1)),
                 [F8, F8, F8], ("mem/w", "extra"), [True, True, True],
                 "rollback-bitwise", device)
    assert pass_rollback_coverage(t) == []
    t = _guarded(lambda m, e, g: _bitwise_restore(m, e, g, (0, 0)),
                 [F8, F8, F8], ("mem/w", "extra"), [True, True, True],
                 "rollback-crossed", device)
    findings = pass_rollback_coverage(t)
    assert len(findings) == 1 and "'extra'" in findings[0].message


def test_rollback_coverage_honors_declared_exclusions():
    """Leaves under a GUARD_ROLLBACK_EXCLUDED name are written through:
    the guard's own counters."""
    def ok(count, step, g):
        nf = ~torch.isfinite(g).all()
        return torch.where(nf, count, count + 1), step + 1

    t = _guarded(ok, [I32, I32, F8], ("count", "step"),
                 [False, False, True], "rollback-excluded")
    assert pass_rollback_coverage(t) == []


def test_rollback_coverage_noops_without_guard():
    t = trace_fn(lambda count, g: count + 1, [I32, F8], state=("count",),
                 varying=[False, True], name="no-guard")
    assert pass_rollback_coverage(t) == []


GUARDED = next(e for e in AUDIT_CONFIGS
               if e["name"] == "topk-guard-consensus")


def test_guarded_step_probe_proves_count_and_fallback():
    """The real guarded step: settled as bad, every host leaf is as it
    went in; as good, count advances; fallback follows the verdict."""
    t = trace_config(GUARDED)
    p = t.guard_probe
    host = {k: {path: v for path, v in p[k] if not isinstance(v,
                                                              TensorRef)}
            for k in ("in", "bad", "good")}
    assert host["bad"] == host["in"]
    assert host["good"]["grace/inner/count"] \
        == host["in"]["grace/inner/count"] + 1
    assert host["good"]["grace/inner/fallback"] is True
    assert pass_rollback_coverage(t) == []


def test_rollback_coverage_fires_when_the_guard_skips_a_field(monkeypatch):
    """A guard that neither snapshots nor restores the residuals: the
    residual leaves keep a bad step's values."""
    monkeypatch.setattr(G, "_state_tensors", lambda state: [])
    findings = pass_rollback_coverage(trace_config(GUARDED))
    paths = sorted(dict(f.details)["path"] for f in findings)
    assert paths == ["grace/inner/mem/0", "grace/inner/mem/1"], findings


def test_rollback_coverage_fires_when_settle_advances_count(monkeypatch):
    """A settle that advances count on a bad step too."""
    def settle(self):
        if self._pending is not None:
            self._pending.read()
            self._pending = None
            self._inner = dataclasses.replace(self._inner,
                                              count=self._inner.count + 1)

    monkeypatch.setattr(G.GuardState, "settle", settle)
    findings = pass_rollback_coverage(trace_config(GUARDED))
    messages = [f.message for f in findings]
    assert any("'grace/inner/count' is 1 after a bad step" in m
               for m in messages), messages
    assert any("fallback reads False where the guard's verdict read 1" in m
               for m in messages), messages


# ---------------------------------------------------------------------------
# pass 10: replication contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ROUTES)
def test_replication_contract_fires_on_rank_varying_write(device):
    """A rank-varying value written into a replicated field's device
    leaf: the adapt-rung desync class."""
    def bad(err_sum, g):
        return (err_sum + g.sum(),)

    t = trace_fn(bad, [F0, F8], varying=[False, True], device=device,
                 state=("adapt/err_sum",), name="repl-violation")
    findings = pass_replication_contract(t)
    assert any("'adapt/err_sum'" in f.message and f.severity == "error"
               for f in findings), findings


@pytest.mark.parametrize("device", ROUTES)
def test_replication_contract_blesses_full_axis_reduction(device):
    def ok(err_sum, g):
        s = g.sum()
        dist.all_reduce(s)
        return (err_sum + s,)

    t = trace_fn(ok, [F0, F8], varying=[False, True], device=device,
                 state=("adapt/err_sum",), name="repl-allreduce")
    assert pass_replication_contract(t) == []


def test_replication_contract_warns_on_dead_varying_field():
    def lazy(mem, g):
        dist.all_reduce(mem)
        return (mem / 8.0,)

    t = trace_fn(lazy, [F8, F8], state=("mem/w",), name="repl-dead")
    findings = pass_replication_contract(t)
    assert [(f.severity, "'mem'" in f.message) for f in findings] \
        == [("warning", True)], findings


def _count_step(source):
    def fn(g, fields):
        if source == "rank":
            fields["count"] += dist.get_rank()
        elif source == "local read":
            fields["count"] += int(g.sum().item())
        elif source == "replicated read":
            s = g.sum()
            dist.all_reduce(s)
            fields["count"] += int(s.item())
        else:
            fields["count"] += 1
    return fn


@pytest.mark.parametrize("source,fires", [
    ("rank", True), ("local read", True), ("replicated read", False),
    ("constant", False)])
def test_replication_contract_host_fields(source, fires):
    """A replicated host field must be the same on rank 0 and rank W−1,
    where a host read of a rank-varying value gets another stub."""
    t = trace_fn(_count_step(source), [F8], host={"count": 0, "seed": 0},
                 name=f"host-{source}")
    findings = pass_replication_contract(t)
    assert bool(findings) == fires, findings
    if fires:
        assert "replicated host field 'count'" in findings[0].message


def test_contract_constants_do_not_drift():
    assert _contract_drift() == ()


@pytest.mark.parametrize("seed", ["unroled", "carry"])
def test_contract_drift_fires(seed, monkeypatch):
    from grace_tpu_torch import transform as T

    if seed == "unroled":
        monkeypatch.setattr(T, "GRACE_HOST_FIELDS", ())
        want = "appear in none"
    else:
        monkeypatch.setattr(T, "carry_replicated", lambda old, fresh: fresh)
        want = "carry_replicated takes field"
    _contract_drift.cache_clear()
    try:
        drift = _contract_drift()
        assert any(want in m for m in drift), drift
        t = trace_fn(lambda x: x, [F8], name="drift")
        assert [f.severity for f in pass_replication_contract(t)] \
            == ["error"] * len(drift)
    finally:
        monkeypatch.undo()
        _contract_drift.cache_clear()


# ---------------------------------------------------------------------------
# the field roles against their consumers (satellite pins)
# ---------------------------------------------------------------------------

def test_field_roles_exactly_cover_gracestate():
    roles = [set(GRACE_VARYING_FIELDS), set(GRACE_REPLICATED_FIELDS),
             set(GRACE_HOST_FIELDS)]
    fields = {f.name for f in dataclasses.fields(GraceState)}
    assert set().union(*roles) == fields
    assert sum(len(r) for r in roles) == len(fields)
    assert set(GRACE_OBSERVATIONAL_FIELDS) <= roles[0]


@pytest.mark.parametrize("consumer", ["checkpoint", "carry"])
def test_layout_consumers_agree_with_field_roles(consumer):
    """The port's counterparts of JAX's partition_specs check: the
    checkpoint's per-rank split and an elastic resize's carry."""
    from grace_tpu_torch import checkpoint
    from grace_tpu_torch.transform import carry_replicated

    names = [f.name for f in dataclasses.fields(GraceState)]
    old = GraceState(**{f: ("old", f) for f in names})
    if consumer == "checkpoint":
        split = {n: v for n, _x, v in checkpoint._node_children(old)}
        assert split == {f: f in GRACE_VARYING_FIELDS for f in names
                         if f not in GRACE_HOST_FIELDS}
    else:
        fresh = GraceState(**{f: ("fresh", f) for f in names})
        got = carry_replicated(old, fresh)
        assert {f: getattr(got, f)[0] for f in names} == {
            f: "old" if f in GRACE_REPLICATED_FIELDS else "fresh"
            for f in names}


def test_observational_types_match_fields():
    from grace_tpu_torch.telemetry.aggregate import WatchState
    from grace_tpu_torch.telemetry.state import TelemetryState

    assert set(GRACE_OBSERVATIONAL_FIELDS) == {"telem", "watch"}
    assert set(G.GUARD_SCAN_EXCLUDED_TYPES) == {TelemetryState, WatchState}


def test_guard_exclusions_name_real_leaves():
    assert set(G.GUARD_ROLLBACK_EXCLUDED) <= set(G._COUNTERS) | {"fallback"}


def test_ten_passes_registered():
    from grace_tpu.analysis.passes import PASS_NAMES as JAX_PASS_NAMES
    assert PASS_NAMES == JAX_PASS_NAMES and len(PASS_NAMES) == 10
    run_passes(trace_fn(lambda x: x + 1.0, [F8], name="resolve-all"),
               PASS_NAMES)


# ---------------------------------------------------------------------------
# the repo rules
# ---------------------------------------------------------------------------

def test_repo_rules_clean():
    findings = run_repo_rules()
    assert findings == [], "\n".join(f"{f.config}: {f.message}"
                                     for f in findings)


def test_rules_cli():
    rc = cli(["--rules"])
    assert rc == 0


def _transform_src():
    with open(os.path.join(repo_root(), "grace_tpu_torch",
                           "transform.py")) as f:
        return f.read()


def test_field_role_rule_clean_on_repo():
    assert run_repo_rules(rules=("grace-state-field-roles",)) == []


@pytest.mark.parametrize("case", ["unroled", "ghost", "twice"])
def test_field_role_rule_fires(case):
    src = _transform_src()
    line = 'GRACE_HOST_FIELDS = ("world",)'
    if case == "unroled":
        bad = src.replace("    adapt: Optional[\"AdaptState\"] = None",
                          "    adapt: Optional[\"AdaptState\"] = None\n"
                          "    shiny_new: Any = None", 1)
        field = "shiny_new"
    elif case == "ghost":
        bad = src.replace(line, 'GRACE_HOST_FIELDS = ("world", "ghost")', 1)
        field = "ghost"
    else:
        bad = src.replace(line, 'GRACE_HOST_FIELDS = ("world", "count")', 1)
        field = "count"
    assert bad != src
    findings = run_repo_rules(rules=("grace-state-field-roles",),
                              sources={"grace_tpu_torch/transform.py": bad})
    assert [dict(f.details).get("field") for f in findings] == [field]


def test_rule_fires_on_undeclared_compressor():
    src = ("from grace_tpu_torch.core import Compressor\n"
           "class ShinyNewCompressor(Compressor):\n"
           "    ratio: float = 0.5\n")
    findings = run_repo_rules(
        rules=("compressor-capabilities",),
        sources={"grace_tpu_torch/compressors/shiny.py": src})
    mine = [f for f in findings if "ShinyNewCompressor" in f.message]
    assert len(mine) == 1 and "payload_algebra" in mine[0].message


def test_rule_fires_on_bad_fields_reducer():
    src = 'FIELDS = (("grad_norm", "mean"), ("mystery", "median"))\n'
    findings = run_repo_rules(
        rules=("telemetry-fields-reducer",),
        sources={"grace_tpu_torch/telemetry/state.py": src})
    assert len(findings) == 1 and "median" in findings[0].message


def test_rule_fires_on_unregistered_marker():
    src = ("import pytest\n"
           "@pytest.mark.totally_new_marker\n"
           "def test_x():\n    pass\n")
    findings = run_repo_rules(
        rules=("pytest-marker-registration",),
        sources={"tests/test_torch_fake_marker.py": src})
    assert [dict(f.details)["marker"] for f in findings] \
        == ["totally_new_marker"]


def test_analysis_marker_is_registered():
    assert "analysis" in registered_markers(repo_root())
    assert RULE_NAMES == ("compressor-capabilities",
                          "telemetry-fields-reducer",
                          "pytest-marker-registration",
                          "grace-state-field-roles")


# ---------------------------------------------------------------------------
# the JAX package on the same hazards
# ---------------------------------------------------------------------------

def _jax_hazard(case):
    """The JAX package's verdict (does its pass fire?) on its form of a
    hazard above (``tests/test_state_passes.py``'s graphs)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from grace_tpu.analysis import state_passes as S
    from grace_tpu.analysis.trace import trace_fn as jtrace
    from grace_tpu.core import DEFAULT_AXIS

    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    f8 = jax.ShapeDtypeStruct((8,), jnp.float32)
    f4 = jax.ShapeDtypeStruct((4,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((), jnp.int32)

    def state(t, paths):
        n = len(paths)
        t.state_in_vars = list(zip(paths, t.grad_in[:n]))
        t.state_out_vars = list(zip(paths, t.body.outvars[:n]))
        t.grace_prefixes = ("",)
        return t

    if case == "shared lineage":
        def fn(kd, w, b):
            k = jax.random.fold_in(jax.random.wrap_key_data(kd), 7)
            return (w + jax.random.uniform(k, w.shape),
                    b + jax.random.uniform(k, b.shape))
        return S.pass_rng_lineage(jtrace(fn, [key, f8, f4],
                                         varying=[False, True, True]))
    if case == "rank-varying key":
        def fn(kd, w):
            k = jax.random.fold_in(jax.random.wrap_key_data(kd),
                                   lax.axis_index(DEFAULT_AXIS))
            return w + jax.random.uniform(k, w.shape)
        return S.pass_rng_lineage(jtrace(fn, [key, f8],
                                         varying=[False, True]))
    if case == "unrolled leaf":
        def fn(count, mem, extra, g):
            nf = jnp.any(~jnp.isfinite(g))
            return (jnp.where(nf, count, count + 1),
                    jnp.where(nf, mem, mem + g), extra + 1.0, jnp.sum(g))
        t = jtrace(fn, [i32, f8, f8, f8], varying=[False, True, True, True],
                   meta=GUARD)
        return S.pass_rollback_coverage(state(t, ("count", "mem/w",
                                                  "extra")))
    def fn(count, g):                                   # replicated write
        return count + lax.axis_index(DEFAULT_AXIS), jnp.sum(g)
    t = jtrace(fn, [i32, f8], varying=[False, True])
    return S.pass_replication_contract(state(t, ("count",)))


@pytest.mark.parametrize("case,port", [
    ("shared lineage", test_rng_lineage_fires_on_shared_lineage),
    ("rank-varying key", test_rng_lineage_fires_on_rank_varying_key),
    ("unrolled leaf", test_rollback_coverage_fires_on_unrolled_leaf),
    ("replicated write",
     test_replication_contract_fires_on_rank_varying_write),
])
def test_jax_package_fires_on_the_same_hazard(case, port):
    """The port's seeded hazards are the JAX suite's: JAX's passes fire on
    its form of each, as the port's do on theirs (the tests above)."""
    findings = _jax_hazard(case)
    assert findings and all(f.severity == "error" for f in findings), case
    assert port.__name__.startswith("test_")


def test_cli_json_counts_the_rules(tmp_path):
    path = tmp_path / "rules.json"
    assert cli(["--rules", "--config", "none-allreduce", "--device", "cpu",
                "--json", str(path)]) == 0
    doc = json.loads(path.read_text())
    assert doc["rules_checked"] == 4 and doc["configs_audited"] == 1
    assert doc["errors"] == 0
