"""The port's static auditor (``grace_tpu_torch.analysis``) against the JAX
package's, on the CPU.

Two halves, as in the JAX package's ``tests/test_analysis.py``:

* the registry: every ``AUDIT_CONFIGS`` entry is audited by the JAX
  package (its trace and passes) and by the port's command line on both of
  the port's routes (``--device cpu`` runs the kernels' plain versions,
  ``--device cuda`` the kernel wrappers' fake branches: no card is asked).
  The two give the same ``(config, pass, severity)`` findings, the same
  received bytes counted from the traced collectives and the same
  footprint-model integers. This file audits the even entries, and
  ``test_torch_flow.py`` the odd ones (``--shard``), so that the two files
  together run the command line once over the whole registry on each
  route;
* seeded hazards: each of the JAX suite's deliberately bad graphs in the
  port's form fires its pass, and its clean twin does not.
"""

import dataclasses
import json
import os
import sys

import pytest
import torch
import torch.distributed as dist

from grace_tpu_torch.analysis import (AUDIT_CONFIGS, PASS_NAMES, Branch,
                                      audit_config, build_grace,
                                      count_recv_bytes, fake_world,
                                      pass_bit_exactness,
                                      pass_collective_consistency,
                                      pass_signature_stability,
                                      pass_wire_reconciliation, trace_fn,
                                      trace_update)
from grace_tpu_torch.analysis.__main__ import main as cli
from grace_tpu_torch.analysis.trace import default_param_structs
from grace_tpu_torch.transform import fusion_payload_nbytes

pytestmark = pytest.mark.analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X64 = ((64,), torch.float32)
ROUTES = ("cpu", "cuda")

# The entries whose counted bytes differ from the JAX package's: the port's
# count minus JAX's, in bytes, at W=8 (ROADMAP.md queue 3 logs each cause).
# * The adaptive ladder's signal is one all-gather of the W ranks' error
#   scalars in the port (4·(W−1) = 28 B) where JAX runs a pmean and a pmax
#   (2 · 2·4·(W−1)/W = 14 B): +14.
# * An audit gathers the fingerprint's 2·segments words as int64 in the
#   port (128 B a rank) and as uint32 in JAX (64 B): +448; its repair
#   broadcasts the GraceState's replicated host fields as one int64[8]
#   tensor (112 B) where JAX reduces count, key, flag and audit fields at
#   their own widths (57 B): +55. Over the dp group of 4 on the 2-D mesh:
#   +192 and +47.
# * Allreduce sums int8 levels as int32 in the port (gloo and NCCL carry no
#   int8 sum): homoqsgd's compressed exchange moves 3584 B for JAX's 896,
#   and outweighs the fp16 escape (1792 B) where JAX's does not.
COUNT_DIFFERENCES = {
    "adapt-homoqsgd-ring": 14, "adapt-topk-hier": 14,
    "adapt-powersgd-rankladder": 14,
    "hier-fused-boundary-guard-consensus": 503,
    "adapt-guard-consensus": 573, "retune-incumbent-homoqsgd": 2295,
    "topk-guard-consensus": 503, "ring-guard-consensus": 503,
    "hier-guard-consensus": 503, "bucketed-guard-consensus": 503,
    "homoqsgd-hier-guard-consensus": 503, "hier3-guard-consensus": 503,
    "watch-guard-consensus": 503,
    "rscatter-fsdp-routed-guard-consensus": 239}


def port_count(entry: dict, branches: dict) -> int:
    """The port's counted bytes composed as the JAX package counts its
    traced conds (each at its larger branch): an update's largest branch;
    a train step's largest exchange branch plus what an audit that repairs
    adds to the base step."""
    b = {k: v["recv_bytes"] for k, v in branches.items()}
    if entry["mode"] == "update":
        return max(b.values())
    exchange = max(v for k, v in b.items()
                   if k in ("base", "fallback") or k.startswith("rung"))
    return exchange + b.get("repair", b["base"]) - b["base"]


# ---------------------------------------------------------------------------
# the registry against the JAX package
# ---------------------------------------------------------------------------

def run_cli(out_dir, shard: str) -> dict:
    """The command line over its shard of the whole registry on both
    routes: ``{route: document}``; each call must exit 0 and write its
    JSON and JSONL."""
    docs = {}
    for device in ROUTES:
        path = os.path.join(out_dir, f"audit-{device}.json")
        jsonl = os.path.join(out_dir, f"audit-{device}.jsonl")
        rc = cli(["--all-configs", "--shard", shard, "--device", device,
                  "--json", path, "--jsonl", jsonl])
        assert rc == 0
        with open(path) as f:
            docs[device] = json.load(f)
        assert os.path.exists(jsonl)
    return docs


def jax_audit(name: str) -> dict:
    """The JAX package's audit of registry entry ``name`` over its passes
    (all ten, as the port's): its findings, its counted received bytes (the traced graph's,
    cond branches at their larger count) and, in update mode, its
    footprint model at the audit world."""
    from grace_tpu.analysis import AUDIT_CONFIGS as JAX_CONFIGS
    from grace_tpu.analysis import (build_grace as jax_build, run_passes,
                                    trace_train_step, trace_update as jtu)
    from grace_tpu.analysis.flow import footprint_model
    from grace_tpu.analysis.passes import count_recv_bytes as jax_count
    from grace_tpu.analysis.trace import default_param_structs as jparams

    entry = next(e for e in JAX_CONFIGS if e["name"] == name)
    world = int(entry.get("world") or 8)
    grace = jax_build(entry)
    meta = {"grace": grace, "params": entry.get("params")}
    if entry["mode"] == "train":
        t = trace_train_step(grace, world=world, guard=entry["guard"],
                             consensus=entry["consensus"], name=name,
                             meta=meta, fsdp=entry.get("fsdp"))
    else:
        t = jtu(grace, world=world, name=name, meta=meta,
                fsdp=entry.get("fsdp"))
    out = {"entry": entry,
           "findings": {(f.config, f.pass_name, f.severity)
                        for f in run_passes(t, tuple(entry["passes"]))},
           "recv_bytes": jax_count(t.body, t.axis_name, t.world)}
    if entry["mode"] == "update":
        out["footprint"] = footprint_model(grace, jparams(), world=t.world)
    return out


def registry_parity(entry: dict, docs: dict) -> None:
    """One entry of the port's registry against the JAX package's on both
    of the port's routes (``docs``: the command line's documents)."""
    jax = jax_audit(entry["name"])
    j = jax["entry"]
    assert entry["params"] == j["params"]
    for key in ("mode", "guard", "consensus", "fsdp", "world"):
        assert entry.get(key) == j.get(key), key
    assert tuple(entry["passes"]) == tuple(j["passes"])
    for device, doc in docs.items():
        rep = doc["configs"][entry["name"]]
        found = {(f["config"], f["pass"], f["severity"])
                 for f in rep["findings"]}
        assert found == jax["findings"], (device, rep["findings"])
        counted = port_count(entry, rep["branches"])
        assert counted - jax["recv_bytes"] \
            == COUNT_DIFFERENCES.get(entry["name"], 0), device
        if entry["mode"] == "update":
            for key in ("mem_bytes", "comp_bytes", "telem_bytes",
                        "bookkeeping_bytes", "total_bytes"):
                assert rep["footprint_model"][key] == jax["footprint"][key], \
                    (device, key)
            # The counted wire against the port's own model: within the
            # tolerance wherever the entry reconciles its wire.
            if "wire_reconciliation" in entry["passes"]:
                base = rep["branches"]["base"]["recv_bytes"]
                assert abs(base - rep["model_bytes"]) <= max(
                    0.10 * max(base, rep["model_bytes"]), 256)
    # The routes differ in what runs, never in what moves.
    sigs = {d: {b: v["signature"] for b, v in doc["configs"][
        entry["name"]]["branches"].items()} for d, doc in docs.items()}
    assert sigs["cpu"] == sigs["cuda"]


@pytest.fixture(scope="module")
def cli_docs(tmp_path_factory):
    return run_cli(str(tmp_path_factory.mktemp("audit")), "0/2")


@pytest.mark.parametrize("entry", AUDIT_CONFIGS[0::2],
                         ids=[e["name"] for e in AUDIT_CONFIGS[0::2]])
def test_registry_entry_matches_jax(entry, cli_docs):
    registry_parity(entry, cli_docs)


def test_registry_is_jax_registry():
    from grace_tpu.analysis import AUDIT_CONFIGS as JAX_CONFIGS
    assert [e["name"] for e in AUDIT_CONFIGS] \
        == [e["name"] for e in JAX_CONFIGS]
    assert len(AUDIT_CONFIGS) == 79
    assert sum(e["mode"] == "train" for e in AUDIT_CONFIGS) == 11
    assert sum(bool(e["fsdp"]) for e in AUDIT_CONFIGS) == 5


def test_cli_documents_cover_the_shard(cli_docs):
    for device, doc in cli_docs.items():
        assert doc["errors"] == 0 and doc["device"] == device
        assert set(doc["configs"]) == {e["name"]
                                       for e in AUDIT_CONFIGS[0::2]}
        assert set(doc["passes_run"]) == set(PASS_NAMES)


def test_incompatible_config_traces_to_a_finding():
    """A triad the communicators reject is a trace finding naming why,
    never an exception."""
    findings = audit_config({"name": "bad-triad",
                             "params": {"compressor": "topk",
                                        "memory": "residual",
                                        "communicator": "allreduce"}})
    assert len(findings) == 1 and findings[0].pass_name == "trace"
    assert "summable" in findings[0].message


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

def test_trace_leaves_no_process_group():
    assert not dist.is_initialized()
    trace_update(build_grace({"name": "x", "params": {
        "compressor": "topk", "compress_ratio": 0.3, "memory": "residual",
        "communicator": "allgather"}}))
    assert not dist.is_initialized()


def test_trace_refuses_an_existing_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="exists already"):
            with fake_world(8):
                pass
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# seeded hazards: each pass proven live, on both routes
# ---------------------------------------------------------------------------

def _all_reduce_if_positive(x):
    if x.sum().item() > 0:
        dist.all_reduce(x)
    return x


@pytest.mark.parametrize("device", ROUTES)
def test_divergent_collective_after_rank_local_host_read_fires(device):
    """PASS 1: a Python branch on a rank-local value read to the host, with
    a collective on the branch: the cross-rank deadlock shape. The trace
    takes the branch the stub chooses."""
    t = trace_fn(_all_reduce_if_positive, [X64], device=device,
                 branch=Branch(reads=lambda read: 1.0), name="bad-read")
    findings = pass_collective_consistency(t)
    assert len(findings) == 1 and findings[0].severity == "error"
    assert "varies by rank" in findings[0].message
    assert "test_torch_analysis.py:_all_reduce_if_positive" \
        in findings[0].message


@pytest.mark.parametrize("device", ROUTES)
def test_replicated_host_read_passes(device):
    """The escape's shape: a branch on a replicated flag is legal."""
    def ok(x, flag):
        if flag.item():
            dist.all_reduce(x)
        return x

    t = trace_fn(ok, [X64, ((), torch.bool)], varying=[True, False],
                 device=device, branch=Branch(reads=lambda read: 1),
                 name="escape-shape")
    assert pass_collective_consistency(t) == []


@pytest.mark.parametrize("device", ROUTES)
def test_replication_regained_through_all_reduce(device):
    """A value derived from rank-local data through a full all-reduce is
    replicated again: the guard's OR-reduced verdict."""
    def ok(x):
        bad = (x > 0).any().to(torch.int32)
        dist.all_reduce(bad, op=dist.ReduceOp.MAX)
        if bad.item():
            dist.all_reduce(x)
        return x

    t = trace_fn(ok, [X64], device=device,
                 branch=Branch(reads=lambda read: 1), name="guard-shape")
    assert pass_collective_consistency(t) == []


@pytest.mark.parametrize("device", ROUTES)
def test_float_checksum_all_reduce_fires(device):
    """PASS 2: bit-pattern words summed in float space (the ±0.0 aliasing
    bug class, rebuilt on purpose)."""
    def bad(x):
        words = x.view(torch.int32).to(torch.float32)
        dist.all_reduce(words)
        return words

    findings = pass_bit_exactness(trace_fn(bad, [X64], device=device,
                                           name="bad-checksum"))
    assert len(findings) == 1 and "bit-pattern" in findings[0].message


@pytest.mark.parametrize("device", ROUTES)
def test_integer_checksum_all_reduce_clean(device):
    """The sanctioned shape: the port's masked broadcast, an integer SUM
    of bit words, viewed back as floats."""
    from grace_tpu_torch.comm import masked_broadcast_

    def ok(x):
        masked_broadcast_([x], 0)
        return x.view(torch.int32).view(torch.float32)

    assert pass_bit_exactness(trace_fn(ok, [X64], device=device,
                                       name="masked-broadcast")) == []


def _topk_grace():
    return build_grace({"name": "x", "params": {
        "compressor": "topk", "compress_ratio": 0.3, "memory": "residual",
        "communicator": "allgather"}})


@pytest.mark.parametrize("device", ROUTES)
def test_stale_wire_model_fires(device):
    """PASS 3: a communicator whose model drifted from its collectives
    (half the bytes) is flagged; the honest model reconciles."""
    from grace_tpu_torch import comm

    @dataclasses.dataclass(frozen=True)
    class StaleModelAllgather(comm.Allgather):
        def recv_wire_bytes(self, payload_nbytes, n_elems, world,
                            vote=False):
            return payload_nbytes * max(0, world - 1) // 2

    base = _topk_grace()
    stale = dataclasses.replace(base, communicator=StaleModelAllgather())
    findings = pass_wire_reconciliation(
        trace_update(stale, device=device, name="stale-model"))
    assert len(findings) == 1 and "drift" in findings[0].message
    assert pass_wire_reconciliation(
        trace_update(base, device=device, name="fresh-model")) == []


@pytest.mark.parametrize("device", ROUTES)
def test_wire_count_matches_model_exactly_for_allgather(device):
    grace = _topk_grace()
    t = trace_update(grace, device=device)
    _, comp_b, n_elems = fusion_payload_nbytes(
        grace.compressor, list(default_param_structs().values()), None)
    assert count_recv_bytes(t) == grace.communicator.recv_wire_bytes(
        comp_b, n_elems, t.world)


class _Wrapped:
    """A Grace-like bundle whose transform's update is wrapped."""

    def __init__(self, base, wrap):
        self.base, self.wrap = base, wrap
        self.communicator = base.communicator

    def transform(self, seed=0):
        tx = self.base.transform(seed)
        wrap = self.wrap

        class Tx:
            def init(self, params):
                return tx.init(params)

            def update(self, grads, state):
                return wrap(tx, grads, state)

        return Tx()


@pytest.mark.parametrize("device", ROUTES)
def test_signature_leak_fires(device):
    """PASS 4: a host float leaking into the carried step counter."""
    def leak(tx, grads, state):
        out, new = tx.update(grads, state)
        return out, dataclasses.replace(new, count=new.count + 1.5)

    t = trace_update(_Wrapped(_topk_grace(), leak), device=device,
                     name="leaky")
    findings = pass_signature_stability(t)
    assert any("'count'" in f.message and "fixed point" in f.message
               for f in findings)
    assert pass_signature_stability(
        trace_update(_topk_grace(), device=device)) == []


@pytest.mark.parametrize("device", ROUTES)
def test_host_read_inside_update_fires(device):
    """PASS 4: a host read of a value the step computed, at a site the
    contract does not name (the JAX package's host-callback check)."""
    def sync(tx, grads, state):
        if float(grads["w"].abs().sum()) < 0:
            raise AssertionError
        return tx.update(grads, state)

    findings = pass_signature_stability(trace_update(
        _Wrapped(_topk_grace(), sync), device=device, name="host-read"))
    assert len(findings) == 1
    assert "test_torch_analysis.py:sync" in findings[0].message


def test_jsonl_findings_render_in_telemetry_report(tmp_path):
    """The command line's JSONL renders with the JAX package's
    tools/telemetry_report.py, unchanged."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import telemetry_report

    path = tmp_path / "lint.jsonl"
    rc = cli(["--params", json.dumps({"compressor": "topk",
                                      "memory": "residual",
                                      "communicator": "allreduce"}),
              "--jsonl", str(path)])
    assert rc == 1
    provenance, records, events = telemetry_report.load(str(path))
    assert provenance["tool"] == "grace_tpu_torch.analysis"
    assert records == []
    assert [e["event"] for e in events] == ["lint_finding"]
    assert "lint_finding" in telemetry_report.render(provenance, records,
                                                     events)


def test_cli_rejects_unknown_pass_and_config():
    assert cli(["--passes", "not_a_pass"]) == 2
    assert cli(["--config", "not-a-config"]) == 2
