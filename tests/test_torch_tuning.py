"""The port's tuner (``grace_tpu_torch.tuning``) against the JAX package's
(``grace_tpu.tuning``), on the CPU.

With the JAX package's three bandwidths passed in, the port's static
funnel under ``8`` and ``256,8`` gives JAX's candidate names, each
candidate's stage and verdict, each survivor's ``ici``/``dcn``/``wan``
bytes exactly and its projected step within a relative 1e-9, the ranking
and the shortlist. The port's own H100 figures price the same funnel in
its own documents. Then the JAX suite's cases (``tests/test_tuning.py``
and the tuner's cases of ``test_adapt.py``, ``test_homo.py`` and
``test_shard.py``) in the port's form: the gates, determinism, the
command line in static mode, and a measured run on the CPU in a one-rank
gloo group that skips the kernel candidates and must end with a winner
whose overlap sandwich holds.
"""

import json
import os

import pytest
import torch

from grace_tpu_torch.helper import grace_from_params
from grace_tpu_torch.tuning import (PROJECTION_MODEL, Candidate,
                                    TuneTopology, candidate_legal,
                                    enumerate_candidates, online_funnel,
                                    price_candidate, run_tune, static_prune,
                                    variant_audit_entries,
                                    write_tune_evidence)
from grace_tpu_torch.tuning.__main__ import main as cli
from grace_tpu_torch.tuning.candidates import generated_variants
from grace_tpu_torch.tuning.measure import (MeasureTimeout, bounded_call,
                                            model_structs)
from grace_tpu_torch.tuning.prune import (MAX_REQUANT_CHAIN,
                                          degradation_verdict,
                                          numeric_verdict,
                                          requant_chain_length)

pytestmark = pytest.mark.tune

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W8 = TuneTopology(world=8)
XSLICE = TuneTopology(world=256, slice_size=8)
# The JAX package's bandwidths (its bench.PROJECTION_MODEL), passed to the
# port's cost model to hold the rankings against JAX's.
JAX_CONSTANTS = (9.0e10, 2.5e10, 2.5e8)
# Projected steps are sums of three quotients, rounded to 1e-9 ms.
MS_RTOL = 1e-9


def _jax_constants_match():
    import bench
    return (bench.ICI_RING_BYTES_PER_S, bench.DCN_BYTES_PER_S,
            bench.WAN_BYTES_PER_S) == JAX_CONSTANTS


@pytest.fixture(scope="module")
def jax_doc():
    from grace_tpu.tuning import run_tune as jax_run_tune
    return jax_run_tune(("8", "256,8"), static_only=True, shortlist_n=2,
                        argv="test-static")


@pytest.fixture(scope="module")
def port_doc():
    """The port's full-registry static survey under JAX's bandwidths."""
    return run_tune(("8", "256,8"), static_only=True, shortlist_n=2,
                    argv="test-static", constants=JAX_CONSTANTS)


# ---------------------------------------------------------------------------
# the topology spec and the gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["8", "256,8", " 64 , 4 ", "64x4,8",
                                  "1024,8,256", "64×4"])
def test_topology_parse_matches_jax(spec):
    from grace_tpu.tuning.cost import TuneTopology as JaxTopology
    port, jax_ = TuneTopology.parse(spec), JaxTopology.parse(spec)
    assert (port.world, port.slice_size, port.fsdp, port.region_size,
            port.label, port.devices) == (
        jax_.world, jax_.slice_size, jax_.fsdp, jax_.region_size,
        jax_.label, jax_.devices)


@pytest.mark.parametrize("bad", ["", "8,4,2", "0", "8,0", "8,4,6"])
def test_topology_parse_rejects(bad):
    with pytest.raises(ValueError):
        TuneTopology.parse(bad)


def test_tune_topology_2d_spec():
    t = TuneTopology.parse("64x4,8")
    assert (t.world, t.fsdp, t.slice_size, t.devices, t.label) \
        == (64, 4, 8, 256, "W64x4/slice8")
    assert t.core_topology().slice_size == 8


@pytest.mark.parametrize("params,why", [
    ({"compressor": "topk", "compress_ratio": 0.3, "memory": "residual",
      "communicator": "allreduce"}, "summable_payload"),
    ({"compressor": "fp16", "memory": "none",
      "communicator": "sign_allreduce"}, "vote_aggregate"),
    ({"compressor": "dgc", "compress_ratio": 0.3, "memory": "dgc",
      "communicator": "ring"}, "payload algebra"),
    ({"compressor": "signum", "momentum": 0.9, "memory": "none",
      "communicator": "twoshot"}, "stateless"),
    ({"compressor": "topk", "compress_ratio": 0.01,
      "topk_algorithm": "chunk", "memory": "residual",
      "communicator": "hier", "slice_size": 3}, "does not divide world"),
])
def test_capability_gate_mirrors_runtime(params, why):
    from grace_tpu.tuning.candidates import (Candidate as JaxCandidate,
                                             candidate_legal as jax_legal)
    from grace_tpu.tuning.cost import TuneTopology as JaxTopology
    legal, reason, _ = candidate_legal(Candidate("bad", params, "generated"),
                                       W8)
    assert not legal and why in reason
    jlegal, jreason, _ = jax_legal(JaxCandidate("bad", params, "generated"),
                                   JaxTopology(8))
    assert not jlegal and why in jreason


def test_capability_gate_accepts_the_registry():
    for c in enumerate_candidates(W8):
        legal, reason, _ = candidate_legal(c, W8)
        assert legal, (c.name, reason)


def test_numeric_gate_fp16_hop_sum_at_4096():
    spec = TuneTopology(world=4096)
    reason = numeric_verdict(grace_from_params(
        {"compressor": "fp16", "memory": "none",
         "communicator": "allreduce"}), spec)
    assert reason is not None and "safe_sum_terms(float16)" in reason
    assert numeric_verdict(grace_from_params(
        {"compressor": "bf16", "memory": "none",
         "communicator": "allreduce"}), spec) is None


def test_numeric_gate_vote_bound():
    g = grace_from_params({"compressor": "signsgd", "memory": "none",
                           "communicator": "sign_allreduce"})
    assert numeric_verdict(g, TuneTopology(256)) is None
    reason = numeric_verdict(g, TuneTopology(512))
    assert reason is not None and "vote_exact_max_world" in reason


def test_numeric_gate_shared_scale_2bit():
    base = {"compressor": "homoqsgd", "quantum_num": 1, "use_pallas": False,
            "memory": "residual", "communicator": "ring", "fusion": "flat"}
    homo2 = grace_from_params({**base, "accum_bits": 2})
    assert homo2.compressor.payload_sum_max_world() == 1
    reason = numeric_verdict(homo2, TuneTopology(world=2))
    assert reason is not None and "payload_sum_max_world=1" in reason
    homo4 = grace_from_params({**base, "accum_bits": 4})
    assert numeric_verdict(homo4, TuneTopology(world=4)) is None
    r8 = numeric_verdict(homo4, W8)
    assert r8 is not None and "payload_sum_max_world=7" in r8


def test_numeric_gate_reads_the_codecs_overflow_bound():
    """int8 at quantum_num=32: payload_sum_max_world = 127 // 32 = 3, the
    one constant the runtime gate and flow pass 6 read too."""
    grace = grace_from_params({"compressor": "homoqsgd", "quantum_num": 32,
                               "accum_dtype": "int8", "memory": "none",
                               "communicator": "ring", "fusion": "flat"})
    assert grace.compressor.payload_sum_max_world() == 3
    assert numeric_verdict(grace, TuneTopology(world=3)) is None
    assert "payload_sum_max_world" in numeric_verdict(grace,
                                                      TuneTopology(world=4))


def test_requant_chain_lengths():
    topk = {"compressor": "topk", "compress_ratio": 0.01,
            "topk_algorithm": "chunk", "memory": "residual"}
    ring_topk = grace_from_params({**topk, "communicator": "ring",
                                   "fusion": "flat"})
    hier_topk = grace_from_params({**topk, "communicator": "hier",
                                   "slice_size": 8, "fusion": "flat"})
    fp16_ring = grace_from_params({"compressor": "fp16", "memory": "none",
                                   "communicator": "ring",
                                   "fusion": "flat"})
    gather = grace_from_params({"compressor": "topk", "compress_ratio": 0.3,
                                "memory": "residual",
                                "communicator": "allgather"})
    homo = grace_from_params({"compressor": "homoqsgd", "memory": "residual",
                              "communicator": "ring", "fusion": "flat"})
    assert requant_chain_length(ring_topk, W8) == 7
    assert requant_chain_length(ring_topk, XSLICE) == 255
    assert requant_chain_length(hier_topk, XSLICE) == 8
    assert requant_chain_length(hier_topk, W8) == 7
    assert requant_chain_length(fp16_ring, XSLICE) == 0
    assert requant_chain_length(gather, XSLICE) == 0
    assert requant_chain_length(homo, TuneTopology(4096)) == 0
    assert "ScaleCom" in degradation_verdict(ring_topk, XSLICE)
    assert degradation_verdict(hier_topk, XSLICE) is None
    assert requant_chain_length(hier_topk, XSLICE) <= MAX_REQUANT_CHAIN


def test_cyclictopk_ring_is_legal():
    legal, reason, _ = candidate_legal(
        Candidate("cyclic-ring", {"compressor": "cyclictopk",
                                  "memory": "none", "communicator": "ring",
                                  "fusion": "flat"}), W8)
    assert legal, reason


def test_tuner_generates_routed_fsdp_variant():
    spec = TuneTopology(world=64, slice_size=8, fsdp=4)
    cands = {c.name: c for c in enumerate_candidates(spec)}
    legal, reason, grace = candidate_legal(
        cands["tune-routed-rscatter-fsdp"], spec)
    assert legal, reason
    assert grace.mesh.is_2d and grace.routes


def test_candidates_are_jax_candidates():
    """Every topology's candidates by name, params and kernel mark."""
    from grace_tpu.tuning.candidates import enumerate_candidates as jax_enum
    from grace_tpu.tuning.cost import TuneTopology as JaxTopology
    for spec in ("8", "256,8", "64x4,8", "1024,8,256"):
        port = enumerate_candidates(TuneTopology.parse(spec))
        jax_ = jax_enum(JaxTopology.parse(spec))
        assert [(c.name, c.params, c.source, c.needs_kernel) for c in port] \
            == [(c.name, c.params, c.source, c.tpu_only) for c in jax_]


# ---------------------------------------------------------------------------
# the funnel against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", ["W8", "W256/slice8"])
def test_static_funnel_matches_jax(label, jax_doc, port_doc):
    assert _jax_constants_match()
    js, ps = jax_doc["static"][label], port_doc["static"][label]
    assert [r["candidate"] for r in ps["funnel"]] \
        == [r["candidate"] for r in js["funnel"]]
    for j, p in zip(js["funnel"], ps["funnel"]):
        name = p["candidate"]
        assert (p.get("stage"), p.get("verdict")) \
            == (j.get("stage"), j.get("verdict")), name
        # The reason's class: the gate's own wording, shared by both.
        if j.get("reason"):
            assert p["reason"].split(" ")[0] == j["reason"].split(" ")[0], \
                (name, p["reason"], j["reason"])
        assert p.get("requant_chain") == j.get("requant_chain"), name
        if j.get("predicted"):
            jp, pp = j["predicted"], p["predicted"]
            for key in ("payload_bytes", "negotiation_bytes", "ici_bytes",
                        "dcn_bytes", "wan_bytes", "dense_ici_bytes",
                        "dense_dcn_bytes", "dense_wan_bytes"):
                assert pp[key] == jp[key], (name, key)
            assert pp["projected_step_ms"] == pytest.approx(
                jp["projected_step_ms"], rel=MS_RTOL), name
            assert pp["wire_pipeline_overlap"] == jp["wire_pipeline_overlap"]
        if j.get("flow"):
            assert p["flow"] == j["flow"], name
    assert [r["candidate"] for r in ps["ranking"]] \
        == [r["candidate"] for r in js["ranking"]]
    assert ps["shortlist"] == js["shortlist"]
    assert ps["counts"] == js["counts"]


def test_static_ranks_full_registry_under_both_topologies(port_doc):
    assert set(port_doc["static"]) == {"W8", "W256/slice8"}
    for label, st in port_doc["static"].items():
        assert all(r.get("verdict") for r in st["funnel"]), label
        assert all(r.get("reason") for r in st["funnel"]
                   if r["verdict"] == "rejected"), label
        assert st["counts"]["enumerated"] == len(st["funnel"])
        assert len(st["ranking"]) == st["counts"]["priced"]
    assert port_doc["ok"] is True


def test_static_top_pick_at_xslice_is_sharded_or_hier_family(port_doc):
    st = port_doc["static"]["W256/slice8"]
    top = st["ranking"][0]
    rec = next(r for r in st["funnel"] if r["candidate"] == top["candidate"])
    assert rec["params"]["communicator"] == "rscatter"
    assert rec["requant_chain"] <= 1
    hier = next(r for r in st["ranking"] if "hier" in r["candidate"])
    assert hier["ici_bytes"] > 0 and hier["dcn_bytes"] > 0
    flat = next(r for r in st["funnel"] if r["candidate"] == "topk-allgather")
    assert flat["predicted"]["ici_bytes"] == 0
    assert flat["predicted"]["dcn_bytes"] > 0


def test_funnel_ranks_homomorphic_configs_without_degradation_at_w256(
        port_doc):
    rec = {r["candidate"]: r for r in port_doc["static"]["W256/slice8"]
           ["funnel"]}
    for name in ("homoqsgd-ring", "homoqsgd-hier", "tune-homoqsgd4-hier8"):
        r = rec[name]
        assert r["verdict"] in ("priced", "shortlisted"), (name, r)
        assert r["requant_chain"] == 0, name
        assert r["predicted"]["negotiation_bytes"] > 0, name
    assert (rec["qsgd-ring"]["stage"], rec["qsgd-ring"]["requant_chain"]) \
        == ("degradation", 255)
    order = [x["candidate"] for x in port_doc["static"]["W256/slice8"]
             ["ranking"]]
    assert order.index("homoqsgd-ring") < order.index("qsgd_hier")


def test_prune_funnel_seeded_bad_candidates():
    """Every seeded-bad candidate dies at its own stage with a reason and
    none reaches the shortlist."""
    spec = TuneTopology(world=4096)
    cands = [
        Candidate("bad-capability",
                  {"compressor": "topk", "compress_ratio": 0.3,
                   "memory": "residual", "communicator": "allreduce"},
                  "generated"),
        Candidate("bad-numeric", {"compressor": "fp16", "memory": "none",
                                  "communicator": "allreduce"},
                  "generated"),
        Candidate("bad-degradation",
                  {"compressor": "qsgd", "quantum_num": 64,
                   "use_pallas": False, "memory": "none",
                   "communicator": "ring", "fusion": "flat"}, "generated"),
        Candidate("good",
                  {"compressor": "topk", "compress_ratio": 0.01,
                   "topk_algorithm": "chunk", "memory": "residual",
                   "communicator": "hier", "slice_size": 8,
                   "fusion": "flat"}, "generated"),
    ]
    out = static_prune(cands, spec, model_structs("toy"), shortlist_n=2)
    by = {r["candidate"]: r for r in out["funnel"]}
    for name, stage in (("bad-capability", "capability"),
                        ("bad-numeric", "numeric"),
                        ("bad-degradation", "degradation")):
        assert (by[name]["stage"], by[name]["verdict"]) == (stage,
                                                            "rejected")
        assert by[name]["reason"]
    assert out["shortlist"] == ["good"]
    assert by["good"]["flow"]["overlap_bound"] is not None
    c = out["counts"]
    assert (c["capability_rejected"], c["numeric_rejected"],
            c["degradation_rejected"], c["shortlisted"]) == (1, 1, 1, 1)


@pytest.mark.parametrize("name", ["tune-topk1pct-allgather-bucketed",
                                  "tune-topk1pct-ring-bucketed",
                                  "tune-qsgd4-ring-packed-bucketed"])
def test_bucketed_variants_flow_audit_as_jax(name):
    """Each bucket is its own pipeline: the chunk Top-K all-gather over
    two buckets launches its grouped kernels once a bucket, and the flow
    audit counts JAX's two independent chains (the port once joined the
    buckets in one grouped launch: one chain, a serialization point)."""
    from grace_tpu.tuning.candidates import enumerate_candidates as jax_enum
    from grace_tpu.tuning.cost import TuneTopology as JaxTopology
    from grace_tpu.tuning.prune import _flow_audit as jax_flow_audit
    from grace_tpu_torch.tuning.prune import _flow_audit

    cand = next(c for c in enumerate_candidates(W8) if c.name == name)
    jcand = next(c for c in jax_enum(JaxTopology(8)) if c.name == name)
    record, traced = _flow_audit(cand, 8)
    assert record == jax_flow_audit(jcand.build(), name, 8)
    assert record["independent_chains"] == 2 and not record["errors"]
    if "allgather" in name:
        assert traced.kernel_counts() == {"chunk_compress_feedback": 2,
                                          "chunk_aggregate_dense": 2}


def test_static_stage_refuses_beside_a_process_group(tmp_path):
    """The flow audit's tracer owns a fake default group: with another
    one alive the stage raises, never shortlists without the bound."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="exists already"):
            static_prune(enumerate_candidates(W8)[:2], W8,
                         model_structs("toy"), shortlist_n=1)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

def test_cost_model_is_the_ports_own():
    doc = run_tune(("8",), static_only=True, shortlist_n=0, argv="own")
    cm = doc["cost_model"]
    assert (cm["ici_bytes_per_s"], cm["dcn_bytes_per_s"],
            cm["wan_bytes_per_s"]) == (4.5e11, 5.0e10, 2.5e8)
    assert cm["constants_source"] == PROJECTION_MODEL["constants_source"]
    assert "H100" in cm["constants_source"] \
        and "MODEL ASSUMPTIONS" in cm["constants_source"]
    assert "recv_link_bytes" in cm["rule"]
    assert doc["tool"] == "grace_tpu_torch.tuning"


def test_price_candidate_wire_pipeline_discount():
    structs = model_structs("toy")
    base = {"compressor": "qsgd", "quantum_num": 7, "use_pallas": False,
            "memory": "none", "communicator": "ring", "fusion": "flat"}
    serial = price_candidate(grace_from_params(base), structs, W8)
    piped = price_candidate(grace_from_params({**base, "pipeline": 2}),
                            structs, W8)
    assert serial["wire_pipeline_overlap"] == 0.0
    assert piped["wire_pipeline_overlap"] == 0.25
    for k in ("payload_bytes", "ici_bytes", "dcn_bytes", "wire_ms"):
        assert piped[k] == serial[k], k
    assert piped["projected_step_ms"] == pytest.approx(
        0.75 * serial["projected_step_ms"], abs=1e-9)
    assert piped["dense_projected_step_ms"] \
        == serial["dense_projected_step_ms"]
    p4 = price_candidate(grace_from_params({**base, "pipeline": 4}),
                         structs, W8)
    assert p4["wire_pipeline_overlap"] == 0.375


ADAPTIVE = {"compressor": "homoqsgd", "quantum_num": 7, "memory": "residual",
            "communicator": "ring", "fusion": "flat", "escape": "fp16",
            "telemetry": 16,
            "adapt": {"window": 25, "ladder": [{"quantum_num": 127}]}}


def test_adaptive_candidate_priced_at_steady_state_matches_static():
    structs = {"w": ((4096, 64), torch.float32)}
    static = grace_from_params({k: v for k, v in ADAPTIVE.items()
                                if k not in ("escape", "telemetry",
                                             "adapt")})
    p_static = price_candidate(static, structs, XSLICE)
    p_adapt = price_candidate(grace_from_params(ADAPTIVE), structs, XSLICE)
    assert p_adapt["projected_step_ms"] == p_static["projected_step_ms"]
    assert p_adapt["steady_state_rung"] == 2
    rungs = p_adapt["rung_prices"]
    assert [r["rung"] for r in rungs] == [0, 1, 2]
    assert rungs[0]["codec"] == "FP16Compressor"
    assert (rungs[2]["projected_step_ms"] <= rungs[1]["projected_step_ms"]
            <= rungs[0]["projected_step_ms"])
    assert rungs[2]["payload_bytes"] == p_static["payload_bytes"]
    # The JAX package's rung prices, under its bandwidths.
    import jax
    import jax.numpy as jnp

    from grace_tpu.helper import grace_from_params as jax_build
    from grace_tpu.tuning.cost import (TuneTopology as JaxTopology,
                                       price_candidate as jax_price)
    jp = jax_price(jax_build(ADAPTIVE),
                   {"w": jax.ShapeDtypeStruct((4096, 64), jnp.float32)},
                   JaxTopology(256, 8))
    pp = price_candidate(grace_from_params(ADAPTIVE), structs, XSLICE,
                         constants=JAX_CONSTANTS)
    strip = ("projected_step_ms",)
    assert [{k: v for k, v in r.items() if k not in strip}
            for r in pp["rung_prices"]] \
        == [{k: v for k, v in r.items() if k not in strip}
            for r in jp["rung_prices"]]


def test_funnel_gates_every_rung():
    grc = grace_from_params({
        "compressor": "homoqsgd", "quantum_num": 7, "accum_dtype": "int32",
        "memory": "residual", "communicator": "ring", "fusion": "flat",
        "escape": "fp16", "telemetry": True,
        "adapt": {"window": 5, "ladder": [
            {"quantum_num": 127, "accum_dtype": "int16"}]}})
    assert numeric_verdict(grc, W8) is None
    verdict = numeric_verdict(grc, TuneTopology(world=512))
    assert verdict and "adapt rung" in verdict
    cand = Candidate("bad-adapt-rung", {
        "compressor": "qsgd", "quantum_num": 15, "use_pallas": False,
        "memory": "none", "communicator": "ring", "fusion": "flat",
        "escape": "fp16", "telemetry": True,
        "adapt": {"window": 5, "ladder": [{"compressor": "onebit"}]}})
    legal, reason, _ = candidate_legal(cand, W8)
    assert not legal and "adapt rung" in reason


def test_generated_adaptive_variant_is_legal_and_priced():
    cands = [c for c in generated_variants(W8)
             if c.name == "tune-adapt-homoqsgd4-ring"]
    assert len(cands) == 1
    legal, reason, grace = candidate_legal(cands[0], W8)
    assert legal, reason
    price = price_candidate(grace, {"w": ((512,), torch.float32)}, W8)
    assert len(price["rung_prices"]) == 3


# ---------------------------------------------------------------------------
# the registry's tuner variants
# ---------------------------------------------------------------------------

def test_variant_configs_registered_for_lint():
    from grace_tpu.tuning.candidates import (
        variant_audit_entries as jax_variants)
    from grace_tpu_torch.analysis import AUDIT_CONFIGS
    assert variant_audit_entries() == jax_variants()
    for name, params, _why in variant_audit_entries():
        entry = next(e for e in AUDIT_CONFIGS if e["name"] == name)
        assert entry["params"] == params
    names = {c.name for c in enumerate_candidates(W8)}
    assert {"tune-topk1pct-hier-bucketed",
            "tune-qsgd4-hier-packed"} <= names


@pytest.mark.parametrize("name", ["tune-qsgd4-hier-packed",
                                  "tune-qsgd4-ring-packed-pipelined"])
def test_variant_config_audits_clean(name):
    from grace_tpu_torch.analysis import AUDIT_CONFIGS, audit_config
    cand = next(c for c in enumerate_candidates(W8) if c.name == name)
    legal, reason, _ = candidate_legal(cand, W8)
    assert legal, reason
    entry = next(e for e in AUDIT_CONFIGS if e["name"] == name)
    assert [f for f in audit_config(entry) if f.severity == "error"] == []


# ---------------------------------------------------------------------------
# determinism, the command line, the measured run
# ---------------------------------------------------------------------------

def _canon(path) -> str:
    d = json.loads(path.read_text())
    d.pop("captured_at")
    d["provenance"].pop("generated_utc")
    return json.dumps(d, sort_keys=True)


def test_tune_determinism(tmp_path):
    paths = []
    for i in range(2):
        doc = run_tune(("8",), static_only=True, shortlist_n=1,
                       argv="determinism")
        p = tmp_path / f"tune{i}.json"
        write_tune_evidence(doc, str(p))
        paths.append(p)
    assert _canon(paths[0]) == _canon(paths[1])


def test_cli_static(tmp_path):
    out = tmp_path / "TUNE_LAST.json"
    assert cli(["--static-only", "--topology", "8", "--shortlist", "1",
                "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["tool"] == "grace_tpu_torch.tuning" and doc["static_only"]
    assert doc["static"]["W8"]["counts"]["enumerated"] > 40
    assert cli(["--static-only", "--topology", "8,4,2", "--out", ""]) == 2


def _repo_root_tune():
    path = os.path.join(REPO, "TUNE_LAST.json")
    with open(path, "rb") as f:
        return os.stat(path).st_mtime_ns, f.read()


def test_tune_e2e_cpu_winner_and_sandwich(tmp_path):
    """The whole loop on the CPU: enumerate, prune, measure in a one-rank
    gloo group (the dense anchor interleaved), the kernel candidate
    skipped off the card, the winner stamped with the sandwich."""
    before = _repo_root_tune()
    doc = run_tune(("8",), shortlist_n=2, timed_steps=2, repeats=1,
                   device="cpu", trace_dir=str(tmp_path / "prof"),
                   include=("tune-qsgd4-ring-packed-bucketed-pallas",),
                   argv="e2e")
    assert doc["ok"] is True
    m = doc["measured"]
    assert (m["measured_world"], m["device"]) == (1, "cpu")
    rows = m["rows"]
    assert len(rows) == 2 and all(r["same_session"] for r in rows)
    assert [s["candidate"] for s in m["skipped"]] \
        == ["tune-qsgd4-ring-packed-bucketed-pallas"]
    assert "needs_kernel" in m["skipped"][0]["reason"]
    # The CPU runs the wrappers' plain versions: nothing is launched.
    assert all(r["launches"] == {} for r in rows)
    w = doc["winner"]
    assert w["candidate"] == min(
        rows, key=lambda r: (r["projected_step_ms"],
                             r["candidate"]))["candidate"]
    assert w["topology"] == {"world": 8, "slice_size": None}
    assert type(grace_from_params(dict(w["grace_params"])).communicator)
    s = w["overlap_sandwich"]
    assert s["holds"] and s["violations"] == []
    assert s["static_overlap_bound"] == w["static_overlap_bound"]
    if s["measured_overlap"] is not None:
        assert s["measured_overlap"] <= s["static_overlap_bound"] \
            + s["slack"]
    import torch.distributed as dist
    assert not dist.is_initialized()          # the group was its own
    # No file at the repository's root: the JAX tuner's evidence stays.
    assert _repo_root_tune() == before
    write_tune_evidence(doc, str(tmp_path / "TUNE_LAST.json"))
    assert json.loads((tmp_path / "TUNE_LAST.json").read_text())["ok"]


def test_measurement_failure_is_not_skipped(monkeypatch):
    """A candidate whose step fails ends the measurement: unlike the JAX
    package's (a verdict 'error' and on to the next), no failure of a
    build or a launch is passed over."""
    from grace_tpu_torch.tuning import measure

    real = measure.build_model_step

    def failing(grace, *args, **kwargs):
        if grace.compressor.__class__.__name__ == "TopKCompressor":
            raise RuntimeError("launch failed")
        return real(grace, *args, **kwargs)

    monkeypatch.setattr(measure, "build_model_step", failing)
    cand = next(c for c in enumerate_candidates(W8)
                if c.name == "topk-allgather")
    with measure.measuring_group("cpu") as (group, dev):
        with pytest.raises(RuntimeError, match="launch failed"):
            measure.measure_shortlist([cand], W8, group, timed_steps=1,
                                      repeats=1, device=dev)


def test_online_funnel_on_the_cpu():
    out = online_funnel("8", device="cpu", shortlist_n=1, timed_steps=1)
    assert out["winner"] == out["static"]["shortlist"][0]
    assert out["winner_params"] == out["measured"]["rows"][0]["params"]
    assert out["measured"]["measure_timeout_s"] == 120.0


def test_bounded_call():
    assert bounded_call(lambda: 3, 1.0) == 3
    assert bounded_call(lambda: 4, None) == 4
    import threading
    gate = threading.Event()
    with pytest.raises(MeasureTimeout) as e:
        bounded_call(gate.wait, 0.01, retries=1, label="hang")
    gate.set()
    assert e.value.attempts == 2 and e.value.timeout_s == 0.02
    with pytest.raises(ZeroDivisionError):
        bounded_call(lambda: 1 / 0, 1.0, retries=3)
