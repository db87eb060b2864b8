"""The port's dependence-graph layer and its three passes
(``grace_tpu_torch.analysis.flow``) against the JAX package's, on the CPU.

The registry's odd entries are audited here by the JAX package and the
port's command line on both routes (``test_torch_analysis.py`` audits the
even ones). The rest holds each of the JAX suite's seeded graphs
(``tests/test_flow.py``) in the port's form: the numbers the passes are
built on, and every alarm proven live on a deliberately bad step.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from grace_tpu_torch.analysis import (AUDIT_CONFIGS, build_depgraph,
                                      build_grace, footprint_model,
                                      footprint_report, overlap_summary,
                                      pass_memory_footprint,
                                      pass_numeric_safety,
                                      pass_overlap_schedulability, trace_fn,
                                      trace_update)
from grace_tpu_torch.analysis import flow
from grace_tpu_torch.analysis.configs import audit_config, trace_config
from grace_tpu_torch.comm import vote_exact_max_world
from grace_tpu_torch.telemetry.scopes import STAGE_EXCHANGE, trace_stage

from test_torch_analysis import registry_parity, run_cli

pytestmark = pytest.mark.analysis

X64 = ((64,), torch.float32)
ROUTES = ("cpu", "cuda")


@pytest.fixture(scope="module")
def cli_docs(tmp_path_factory):
    return run_cli(str(tmp_path_factory.mktemp("audit")), "1/2")


@pytest.mark.parametrize("entry", AUDIT_CONFIGS[1::2],
                         ids=[e["name"] for e in AUDIT_CONFIGS[1::2]])
def test_registry_entry_matches_jax(entry, cli_docs):
    registry_parity(entry, cli_docs)


def _exchange(fn):
    """``fn`` under the exchange stage, the vocabulary chain counting keys
    on."""
    def wrapped(*args):
        with trace_stage(STAGE_EXCHANGE):
            return fn(*args)
    return wrapped


def _topk_grace(**extra):
    return build_grace({"name": "x", "params": {
        "compressor": "topk", "compress_ratio": 0.3, "memory": "residual",
        "communicator": "allgather", **extra}})


# ---------------------------------------------------------------------------
# the dependence graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ROUTES)
def test_depgraph_ancestor_closure(device):
    """c = all_reduce(a*2); d = c + b*3: the all-reduce is an ancestor of
    the add and not the other way round; the add's gradient roots cover
    both inputs, the all-reduce's only the first."""
    def f(a, b):
        c = a * 2.0
        dist.all_reduce(c)
        return c + b * 3.0

    g = build_depgraph(trace_fn(f, [X64, X64], device=device))
    colls = [n for n in g.nodes if n.collective]
    assert len(colls) == 1
    final = [n for n in g.nodes if n.prim == "aten.add.Tensor"][-1]
    assert g.is_ancestor(colls[0].idx, final.idx)
    assert not g.is_ancestor(final.idx, colls[0].idx)
    assert g.n_grad_roots == 2
    assert colls[0].roots == 0b01
    assert final.roots == 0b11


@pytest.mark.parametrize("device", ROUTES)
def test_depgraph_keeps_in_place_writes_through_views(device):
    """The edges are keyed on storage and each write to it: an in-place
    write through a view of ``a`` feeds the all-reduce of ``a``, and the
    all-reduce's in-place result feeds what reads ``a`` after it."""
    def f(a):
        a.view(-1)[:32].mul_(2.0)
        dist.all_reduce(a)
        return a.sum()

    g = build_depgraph(trace_fn(f, [X64], device=device))
    mul = next(n for n in g.nodes if n.prim == "aten.mul_.Tensor")
    coll = next(n for n in g.nodes if n.collective)
    total = next(n for n in g.nodes if n.prim.startswith("aten.sum"))
    assert g.is_ancestor(mul.idx, coll.idx)
    assert g.is_ancestor(coll.idx, total.idx)


# ---------------------------------------------------------------------------
# pass 5: overlap schedulability
# ---------------------------------------------------------------------------

def _serialized(a, b):
    s1 = a * 2.0
    dist.all_reduce(s1)
    s2 = s1 + b
    dist.all_reduce(s2)
    return s2


def _parallel(a, b):
    s1, s2 = a * 2.0, b * 3.0
    dist.all_reduce(s1)
    dist.all_reduce(s2)
    return s1 + s2


@pytest.mark.parametrize("device", ROUTES)
def test_serialized_bucket_graph_fires(device):
    """Bucket 2's exchange consumes bucket 1's result: two promised chains
    collapse into one."""
    t = trace_fn(_exchange(_serialized), [X64, X64], device=device,
                 name="serialized", meta={"expected_chains": 2})
    s = overlap_summary(t)
    assert s["exchange_collectives"] == 2 and s["independent_chains"] == 1
    findings = pass_overlap_schedulability(t)
    assert len(findings) == 1 and findings[0].severity == "error"
    assert "serialization point" in findings[0].message
    assert findings[0].stage == STAGE_EXCHANGE


@pytest.mark.parametrize("device", ROUTES)
def test_independent_bucket_graph_clean(device):
    t = trace_fn(_exchange(_parallel), [X64, X64], device=device,
                 meta={"expected_chains": 2})
    assert overlap_summary(t)["independent_chains"] == 2
    assert pass_overlap_schedulability(t) == []


def test_static_overlap_bound_zero_when_everything_chains():
    def chained(x):
        y = x * 2.0 + 1.0
        dist.all_reduce(y)
        return y * 3.0

    assert overlap_summary(trace_fn(chained, [X64]))[
        "static_overlap_bound"] == 0.0


def test_static_overlap_bound_positive_with_independent_compute():
    def overlappable(x, z):
        dist.all_reduce(x)
        return x, torch.tanh(z * 2.0) + torch.tanh(z * 3.0)

    s = overlap_summary(trace_fn(overlappable, [X64, X64]))
    assert s["static_overlap_bound"] == 1.0
    assert s["per_collective"][0]["independent_compute_bytes"] > 0


def test_measured_overlap_exceeding_static_bound_fires():
    def chained(x):
        y = x * 2.0
        dist.all_reduce(y)
        return y * 3.0

    findings = pass_overlap_schedulability(trace_fn(
        chained, [X64], meta={"measured_overlap": 0.8}))
    assert len(findings) == 1
    d = dict(findings[0].details)
    assert d["measured_overlap"] == 0.8 and d["static_overlap_bound"] == 0.0
    assert pass_overlap_schedulability(trace_fn(
        chained, [X64], meta={"measured_overlap": 0.0})) == []


def _entry(name):
    return next(e for e in AUDIT_CONFIGS if e["name"] == name)


@pytest.mark.parametrize("device", ROUTES)
def test_bucketed_registry_config_exposes_two_chains(device):
    t = trace_config(_entry("topk-allgather-bucketed"), device=device)
    assert flow._expected_chains(t) == 2
    assert overlap_summary(t)["independent_chains"] == 2
    assert pass_overlap_schedulability(t) == []


@pytest.mark.parametrize("device", ROUTES)
def test_pipelined_ring_registry_config_exposes_pipeline_chains(device):
    entry = _entry("qsgd2-ring-packed-pipelined")
    t = trace_config(entry, device=device)
    assert t.meta["grace"].communicator.pipeline == 2
    assert flow._expected_chains(t) == 2
    assert overlap_summary(t)["independent_chains"] == 2
    serial = dict(entry, params={**entry["params"], "pipeline": 1})
    assert overlap_summary(trace_config(serial, device=device))[
        "independent_chains"] == 1


# ---------------------------------------------------------------------------
# pass 6: numeric-range safety
# ---------------------------------------------------------------------------

def _f16_sum(x):
    h = x.to(torch.float16)
    dist.all_reduce(h)
    return h


def test_fp16_hop_sum_overflows_at_large_world():
    """A W=4096 fp16 payload sum passes the 65504 cliff."""
    findings = pass_numeric_safety(trace_fn(_f16_sum, [X64], world=4096))
    assert len(findings) == 1
    d = dict(findings[0].details)
    assert d["dtype"] == "float16" and d["terms"] == 4096
    assert "overflows to inf" in findings[0].message
    assert pass_numeric_safety(trace_fn(_f16_sum, [X64], world=8)) == []

    def bf16_sum(x):
        h = x.to(torch.bfloat16)
        dist.all_reduce(h)
        return h

    assert pass_numeric_safety(trace_fn(bf16_sum, [X64], world=4096)) == []


def test_safe_sum_terms_derivation():
    assert flow.safe_sum_terms(torch.float16) == int(65504 / 256)
    assert flow.safe_sum_terms(torch.bfloat16) > 10 ** 30
    assert flow.safe_sum_terms(torch.int32) is None


def test_vote_exact_max_world_rederives_256_from_first_principles():
    """p explicit mantissa bits hold every integer up to 2^(p+1), and a
    W-rank tally lies in [-W, W]."""
    nmant = round(-np.log2(torch.finfo(torch.bfloat16).eps))
    assert vote_exact_max_world("bfloat16") == 2 ** (nmant + 1) == 256
    assert vote_exact_max_world("float16") == 2048
    assert vote_exact_max_world("float32") == 2 ** 24
    with pytest.raises(TypeError):
        vote_exact_max_world(torch.int32)


def test_runtime_vote_guard_reads_the_same_constant():
    """The vote's runtime check, met tracing past its bound, is a trace
    finding naming the constant."""
    findings = audit_config({"name": "vote-512", "params": {
        "compressor": "signsgd", "memory": "none",
        "communicator": "sign_allreduce"}}, world=512)
    assert len(findings) == 1 and findings[0].pass_name == "trace"
    assert "vote_exact_max_world" in findings[0].message


def _vote(x):
    v = x.to(torch.bfloat16)
    with trace_stage(f"{STAGE_EXCHANGE}/psum_vote"):
        dist.all_reduce(v)
    return v


def test_hand_rolled_vote_psum_past_bound_fires_statically():
    findings = pass_numeric_safety(trace_fn(_vote, [X64], world=512))
    assert len(findings) == 1
    assert dict(findings[0].details)["exact_max_world"] == 256
    assert pass_numeric_safety(trace_fn(_vote, [X64], world=256)) == []


def test_undersized_index_dtype_fires():
    """A selection codec shipping int16 indices for a 100k-element leaf:
    positions past 32767 wrap on decode."""
    from grace_tpu_torch.core import Compressor

    @dataclasses.dataclass(frozen=True)
    class NarrowTopK(Compressor):
        summable_payload = False

        def compress(self, x, state, rng):
            flat = x.reshape(-1)
            idx = torch.topk(flat.abs(), 16).indices
            return ((flat[idx], idx.to(torch.int16)),
                    (flat.numel(), x.shape, x.dtype), state)

        def decompress(self, payload, ctx):
            values, idx = payload
            n, shape, dtype = ctx
            out = torch.zeros(n, dtype=dtype, device=values.device)
            return out.index_put_((idx.long(),), values).reshape(shape)

    base = _topk_grace()
    grace = dataclasses.replace(base, compressor=NarrowTopK())
    big = {"w": ((100_000,), torch.float32)}
    findings = pass_numeric_safety(trace_update(
        grace, params=big, meta={"grace": grace, "param_structs": big}))
    assert len(findings) == 1
    assert "int16 index payload" in findings[0].message
    assert pass_numeric_safety(trace_update(
        base, params=big, meta={"grace": base, "param_structs": big})) == []


def _sign_trace():
    grace = build_grace({"name": "x", "params": {
        "compressor": "signsgd", "memory": "none",
        "communicator": "allgather"}})
    return trace_update(grace, meta={"grace": grace})


def test_broken_bit_packer_fires():
    """An injected 3-lanes-a-byte 'pack_bits': in-range codes truncate."""
    from grace_tpu_torch.ops.packing import unpack_bits

    def bad_pack(bits):
        n = bits.shape[0]
        nbytes = -(-n // 3)
        padded = torch.zeros(nbytes * 3, dtype=torch.uint8)
        padded[:n] = bits.to(torch.uint8)
        return padded.reshape(nbytes, 3).sum(1, dtype=torch.uint8)

    t = _sign_trace()
    findings = flow._packing_findings(
        t, pack_fns=((1, bad_pack, unpack_bits),))
    assert findings and all("ops/packing" in f.message for f in findings)
    assert flow._packing_findings(t) == []


@pytest.mark.parametrize("width", [2, 3, 4])
def test_bad_packer_fires_at_every_subbyte_width(width):
    """A packer that declares ``width`` bits but packs ``width - 1``."""
    from grace_tpu_torch.ops.packing import pack_widths

    good = {w: (p, u) for w, p, u in pack_widths()}
    narrow_pack, _ = good[width - 1]
    _, wide_unpack = good[width]

    def truncating_pack(codes):
        return narrow_pack(codes & ((1 << (width - 1)) - 1))

    grace = build_grace({"name": "x", "params": {
        "compressor": "qsgd", "quantum_num": 7, "memory": "none",
        "communicator": "allgather"}})
    t = trace_update(grace, meta={"grace": grace})
    findings = flow._packing_findings(
        t, pack_fns=((width, truncating_pack, wide_unpack),))
    assert findings
    assert all("ops/packing" in f.message and f"{width}-bit" in f.message
               for f in findings)


def test_packing_check_only_runs_for_packed_payloads():
    grace = build_grace({"name": "x", "params": {
        "compressor": "fp16", "memory": "none",
        "communicator": "allreduce"}})
    t = trace_update(grace, meta={"grace": grace})

    def exploding_pack(bits):
        raise AssertionError("packing check ran for an unpacked codec")

    assert flow._packing_findings(
        t, pack_fns=((1, exploding_pack, exploding_pack),)) == []


# ---------------------------------------------------------------------------
# pass 7: memory footprint
# ---------------------------------------------------------------------------

def test_footprint_model_matches_a_live_state_at_world8(tmp_path):
    """The pass's model equals grace_state_footprint of one rank's live
    state (init on the CPU in a gloo group of one, scaled to world 8)."""
    from grace_tpu_torch.profiling import grace_state_footprint

    grace = build_grace({"name": "smoke", "params": {
        "compressor": "topk", "compress_ratio": 0.3, "memory": "residual",
        "communicator": "allgather", "escape": "fp16", "telemetry": 32}})
    params = {"w": torch.zeros(32, 16), "b": torch.zeros(16)}
    model = footprint_model(grace, params, world=8)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        live = grace_state_footprint(grace.transform(seed=0).init(params),
                                     world=8)
    finally:
        dist.destroy_process_group()
    for key in ("mem_bytes", "comp_bytes", "telem_bytes", "total_bytes"):
        assert live[key] == model[key], key


@pytest.mark.parametrize("device", ROUTES)
def test_footprint_report_groups_match_the_model(device):
    from grace_tpu_torch.analysis.trace import default_param_structs

    grace = _topk_grace(telemetry=16)
    rep = footprint_report(trace_update(grace, device=device,
                                        meta={"grace": grace}))
    model = footprint_model(grace, default_param_structs())
    for key in ("mem_bytes", "comp_bytes", "telem_bytes"):
        assert rep[key] == model[key], key
    assert rep["wire_peak_bytes"] > 0
    assert rep["wire_total_bytes"] >= rep["wire_peak_bytes"]
    assert rep["n_collectives"] >= 2


def test_state_traced_under_different_config_fires():
    ga, gb = _topk_grace(telemetry=4), _topk_grace(telemetry=64)
    findings = pass_memory_footprint(trace_update(ga, meta={"grace": gb}))
    assert len(findings) == 1 and "different" in findings[0].message
    assert dict(findings[0].details)["component"] == "telem_bytes"
    assert pass_memory_footprint(trace_update(ga, meta={"grace": ga})) == []


def test_replicated_o_w_buffer_fires():
    """A replicated state tensor shaped (W,): O(W) memory on every rank."""
    base = _topk_grace()

    class OWGrace:
        communicator = base.communicator

        def transform(self, seed=0):
            tx = base.transform(seed)

            class Tx:
                def init(self, params):
                    state = tx.init(params)
                    device = next(iter(params.values())).device
                    return dataclasses.replace(
                        state, audit=torch.zeros(8, device=device))

                def update(self, grads, state):
                    return tx.update(grads, state)

            return Tx()

    findings = pass_memory_footprint(trace_update(OWGrace()))
    assert len(findings) == 1
    assert "O(W)" in findings[0].message
    assert dict(findings[0].details)["path"] == "audit"


def test_replicated_state_scalars_do_not_fire():
    """The adaptive ladder's replicated window statistics are 0-d."""
    grace = build_grace({"name": "x", "params": {
        "compressor": "topk", "compress_ratio": 0.05, "memory": "residual",
        "communicator": "allgather", "escape": "fp16", "telemetry": True,
        "adapt": {"window": 5, "ladder": [{"compress_ratio": 0.2}]}}})
    t = trace_update(grace)
    assert [p for p, _ in t.state_replicated]
    assert pass_memory_footprint(t) == []
