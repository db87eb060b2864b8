"""The audited config registry: the codec x communicator matrix the port
supports; counterpart of the JAX package's ``analysis/configs.py``, with
its entries under its names and params.

:func:`audit_config` traces one entry's every host branch
(:func:`branches`: the escape window, each ladder rung, an audit step, a
watch window, a steady step after a guard verdict) at the entry's world
with :func:`~grace_tpu_torch.analysis.trace.trace_update` (or
:func:`~grace_tpu_torch.analysis.trace.trace_train_step` for
``mode='train'``), on the card's route by default, and runs the entry's
passes on each. Wire reconciliation runs on update traces without an
escape or a ladder, whose wire cost depends on the branch; train entries
leave it out (the audit's gathers and the loss mean are outside the
exchange model). A config that fails to trace is a ``trace`` finding.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from grace_tpu_torch.analysis.passes import Finding, PASS_NAMES, run_passes
from grace_tpu_torch.analysis.trace import (Branch, TracedGraph,
                                            trace_train_step, trace_update)

__all__ = ["AUDIT_CONFIGS", "audit_all", "audit_config", "audit_traces",
           "branches", "build_grace", "model_param_structs",
           "overlap_bound_report", "trace_config"]

_ALL = tuple(PASS_NAMES)
_NO_WIRE = tuple(p for p in PASS_NAMES if p != "wire_reconciliation")


def _cfg(name: str, params: Dict[str, Any], *, passes=_ALL, mode="update",
         guard=None, consensus=None, fsdp=None,
         world=None) -> Dict[str, Any]:
    # world: the entry's own audit world, where its payload accumulator
    # bounds the world it supports (packed sub-byte homoqsgd).
    return {"name": name, "params": params, "passes": passes, "mode": mode,
            "guard": guard, "consensus": consensus, "fsdp": fsdp,
            "world": world}


AUDIT_CONFIGS: List[Dict[str, Any]] = [
    # -- linear codecs: the summable-payload all-reduce family
    _cfg("none-allreduce", {"compressor": "none", "memory": "none",
                            "communicator": "allreduce"}),
    _cfg("fp16-allreduce", {"compressor": "fp16", "memory": "none",
                            "communicator": "allreduce"}),
    _cfg("randomk-allreduce", {"compressor": "randomk",
                               "compress_ratio": 0.5, "memory": "residual",
                               "communicator": "allreduce"}),
    _cfg("powersgd-allreduce", {"compressor": "powersgd",
                                "compress_rank": 2, "memory": "powersgd",
                                "communicator": "allreduce"}),
    # -- the general-purpose all-gather family
    _cfg("topk-allgather", {"compressor": "topk", "compress_ratio": 0.3,
                            "memory": "residual",
                            "communicator": "allgather"}),
    _cfg("randomk-allgather", {"compressor": "randomk",
                               "compress_ratio": 0.5, "memory": "residual",
                               "communicator": "allgather"}),
    _cfg("qsgd-allgather", {"compressor": "qsgd", "quantum_num": 64,
                            "use_pallas": False, "memory": "none",
                            "communicator": "allgather"}),
    _cfg("terngrad-allgather", {"compressor": "terngrad", "memory": "none",
                                "communicator": "allgather"}),
    _cfg("signsgd-allgather", {"compressor": "signsgd", "memory": "none",
                               "communicator": "allgather"}),
    _cfg("signum-allgather", {"compressor": "signum", "momentum": 0.9,
                              "memory": "none",
                              "communicator": "allgather"}),
    _cfg("efsignsgd-allgather", {"compressor": "efsignsgd", "lr": 0.1,
                                 "memory": "efsignsgd",
                                 "communicator": "allgather"}),
    _cfg("onebit-allgather", {"compressor": "onebit", "memory": "residual",
                              "communicator": "allgather"}),
    _cfg("natural-allgather", {"compressor": "natural",
                               "memory": "residual",
                               "communicator": "allgather"}),
    _cfg("dgc-allgather", {"compressor": "dgc", "compress_ratio": 0.3,
                           "memory": "dgc", "communicator": "allgather"}),
    _cfg("threshold-allgather", {"compressor": "threshold",
                                 "threshold": 0.01,
                                 "memory": "residual",
                                 "communicator": "allgather"}),
    _cfg("sketch-allgather", {"compressor": "sketch", "quantum_num": 64,
                              "memory": "none",
                              "communicator": "allgather"}),
    _cfg("u8bit-allgather", {"compressor": "u8bit", "memory": "none",
                             "communicator": "allgather"}),
    _cfg("adaq-allgather", {"compressor": "adaq", "compress_ratio": 0.3,
                            "memory": "residual",
                            "communicator": "allgather"}),
    _cfg("inceptionn-allgather", {"compressor": "inceptionn",
                                  "memory": "none",
                                  "communicator": "allgather"}),
    _cfg("topk-broadcast", {"compressor": "topk", "compress_ratio": 0.3,
                            "memory": "residual",
                            "communicator": "broadcast"}),
    # -- vote routing
    _cfg("signsgd-sign_allreduce", {"compressor": "signsgd",
                                    "memory": "none",
                                    "communicator": "sign_allreduce"}),
    _cfg("signsgd-allreduce-vote", {"compressor": "signsgd",
                                    "memory": "none",
                                    "communicator": "allreduce"}),
    # -- shard-parallel families (flat fusion hands them whole buffers)
    _cfg("topk-twoshot", {"compressor": "topk", "compress_ratio": 0.3,
                          "memory": "residual", "communicator": "twoshot",
                          "fusion": "flat"}),
    _cfg("qsgd-twoshot", {"compressor": "qsgd", "quantum_num": 64,
                          "use_pallas": False, "memory": "none",
                          "communicator": "twoshot", "fusion": "flat"}),
    _cfg("topk-ring", {"compressor": "topk", "compress_ratio": 0.3,
                       "memory": "residual", "communicator": "ring",
                       "fusion": "flat"}),
    _cfg("qsgd-ring", {"compressor": "qsgd", "quantum_num": 64,
                       "use_pallas": False, "memory": "none",
                       "communicator": "ring", "fusion": "flat"}),
    _cfg("signsgd-ring", {"compressor": "signsgd", "memory": "none",
                          "communicator": "ring", "fusion": "flat"}),
    _cfg("fp16-ring", {"compressor": "fp16", "memory": "none",
                       "communicator": "ring", "fusion": "flat"}),
    _cfg("randomk-ring", {"compressor": "randomk", "compress_ratio": 0.5,
                          "memory": "residual", "communicator": "ring",
                          "fusion": "flat"}),
    # -- the hierarchical family: slice_size=4 puts a slice boundary inside
    #    the 8-way audit world, so the per-link split reconciles a mixed
    #    ICI/DCN schedule
    _cfg("topk1pct_hier", {"compressor": "topk", "compress_ratio": 0.01,
                           "topk_algorithm": "chunk", "memory": "residual",
                           "communicator": "hier", "slice_size": 4,
                           "fusion": "flat"}),
    _cfg("qsgd_hier", {"compressor": "qsgd", "quantum_num": 64,
                       "use_pallas": False, "memory": "none",
                       "communicator": "hier", "slice_size": 4,
                       "fusion": "flat"}),
    _cfg("none_hier", {"compressor": "none", "memory": "none",
                       "communicator": "hier", "slice_size": 4,
                       "fusion": "flat"}),
    _cfg("signsgd_hier", {"compressor": "signsgd", "memory": "none",
                          "communicator": "hier", "slice_size": 4,
                          "fusion": "flat"}),
    # -- the aggregation-homomorphic family: payloads sum on every hop
    _cfg("homoqsgd-ring", {"compressor": "homoqsgd", "quantum_num": 7,
                           "memory": "residual", "communicator": "ring",
                           "fusion": "flat"}),
    _cfg("homoqsgd-hier", {"compressor": "homoqsgd", "quantum_num": 7,
                           "memory": "residual", "communicator": "hier",
                           "slice_size": 4, "fusion": "flat"}),
    # -- three tiers: slice_size=2 and region_size=4 put a slice and a
    #    region boundary inside the audit world
    _cfg("topk-hier3", {"compressor": "topk", "compress_ratio": 0.25,
                        "topk_algorithm": "chunk", "memory": "residual",
                        "communicator": "hier", "slice_size": 2,
                        "region_size": 4, "fusion": "flat"}),
    _cfg("homoqsgd-hier3", {"compressor": "homoqsgd", "quantum_num": 7,
                            "memory": "residual", "communicator": "hier",
                            "slice_size": 2, "region_size": 4,
                            "fusion": "flat"}),
    # -- the mergeable count-sketch over the gather family
    _cfg("countsketch-allgather", {"compressor": "countsketch",
                                   "compress_ratio": 0.25,
                                   "memory": "residual",
                                   "communicator": "allgather"}),
    # -- the sharded-model track: reduce-scatter on 1-D and dp×fsdp meshes
    #    (fsdp=2 splits the 8-rank world into dp=4 × fsdp=2)
    _cfg("topk-rscatter", {"compressor": "topk", "compress_ratio": 0.3,
                           "memory": "residual", "communicator": "rscatter",
                           "fusion": "flat"}),
    _cfg("fp16-rscatter-fsdp", {"compressor": "fp16", "memory": "none",
                                "communicator": "rscatter",
                                "fusion": "flat", "fsdp_axis": "fsdp"},
         fsdp=2),
    _cfg("topk-rscatter-fsdp", {"compressor": "topk",
                                "compress_ratio": 0.3,
                                "memory": "residual",
                                "communicator": "rscatter",
                                "fusion": "flat", "fsdp_axis": "fsdp"},
         fsdp=2),
    _cfg("homoqsgd-rscatter-fsdp", {"compressor": "homoqsgd",
                                    "quantum_num": 7, "memory": "residual",
                                    "communicator": "rscatter",
                                    "fusion": "flat",
                                    "fsdp_axis": "fsdp"}, fsdp=2),
    # -- cyclic Top-K: a rank-deterministic index set, so exactly summable
    _cfg("cyclictopk-allreduce", {"compressor": "cyclictopk",
                                  "compress_ratio": 0.3,
                                  "memory": "residual",
                                  "communicator": "allreduce"}),
    _cfg("cyclictopk-ring", {"compressor": "cyclictopk",
                             "compress_ratio": 0.3,
                             "memory": "residual",
                             "communicator": "ring",
                             "fusion": "flat"}),
    # -- per-leaf codec routes: the wire model is the sum of the per-leaf
    #    prices
    _cfg("routed-topk-fp16", {"compressor": "topk", "compress_ratio": 0.3,
                              "memory": "residual",
                              "communicator": "allgather",
                              "route": [("b", {"compressor": "fp16",
                                               "memory": "none",
                                               "communicator":
                                                   "allreduce"})]}),
    _cfg("routed-rscatter-fsdp", {"compressor": "topk",
                                  "compress_ratio": 0.3,
                                  "memory": "residual",
                                  "communicator": "rscatter",
                                  "fsdp_axis": "fsdp",
                                  "route": [("b", {"compressor": "fp16",
                                                   "memory": "none",
                                                   "communicator":
                                                       "allreduce"})]},
         fsdp=2),
    # -- degenerate and fusion variants (fusion=1024 splits the default
    #    parameters into K=2 buckets: two independent chains)
    _cfg("none-identity", {"compressor": "none", "memory": "none",
                           "communicator": "identity"}),
    _cfg("topk-allgather-flat", {"compressor": "topk",
                                 "compress_ratio": 0.3,
                                 "memory": "residual",
                                 "communicator": "allgather",
                                 "fusion": "flat"}),
    _cfg("topk-allgather-grouped", {"compressor": "topk",
                                    "compress_ratio": 0.3,
                                    "memory": "residual",
                                    "communicator": "allgather",
                                    "fusion": "grouped"}),
    _cfg("topk-allgather-bucketed", {"compressor": "topk",
                                     "compress_ratio": 0.3,
                                     "memory": "residual",
                                     "communicator": "allgather",
                                     "fusion": 1024}),
    # -- packed wire formats, the kernels' paths with use_pallas=True
    _cfg("qsgd4-allgather-packed", {"compressor": "qsgd", "quantum_num": 7,
                                    "use_pallas": False, "memory": "none",
                                    "communicator": "allgather"}),
    _cfg("qsgd4-ring-packed-bucketed", {"compressor": "qsgd",
                                        "quantum_num": 7,
                                        "use_pallas": False,
                                        "memory": "none",
                                        "communicator": "ring",
                                        "fusion": 1024}),
    _cfg("signsgd-pallas-packed", {"compressor": "signsgd",
                                   "use_pallas": True, "memory": "none",
                                   "communicator": "allgather"}),
    _cfg("qsgd2-ring-packed-pipelined", {"compressor": "qsgd",
                                         "quantum_num": 1,
                                         "use_pallas": False,
                                         "memory": "none",
                                         "communicator": "ring",
                                         "fusion": "flat", "pipeline": 2}),
    # -- accum_bits=4 bounds the exact hop sums at payload_sum_max_world=7:
    #    audited at world=4, inside the bound
    _cfg("homoqsgd4-ring-fused", {"compressor": "homoqsgd",
                                  "quantum_num": 1, "accum_bits": 4,
                                  "use_pallas": True, "memory": "residual",
                                  "communicator": "ring",
                                  "fusion": "flat"}, world=4),
    _cfg("hier-fused-boundary", {"compressor": "qsgd", "quantum_num": 7,
                                 "use_pallas": True, "memory": "none",
                                 "communicator": "hier", "slice_size": 4,
                                 "fusion": "flat"}),
    _cfg("hier-fused-boundary-guard-consensus",
         {"compressor": "qsgd", "quantum_num": 7, "use_pallas": True,
          "memory": "none", "communicator": "hier", "slice_size": 4,
          "fusion": "flat", "escape": "fp16", "consensus": True},
         passes=_NO_WIRE, mode="train",
         guard={"fallback_after": 3, "fallback_steps": 8}, consensus=True),
    # -- the cross-rank watch: a gather every window-th step, on the host's
    #    replicated step counter
    _cfg("topk-watch", {"compressor": "topk", "compress_ratio": 0.3,
                        "memory": "residual", "communicator": "allgather",
                        "telemetry": True, "watch": 5}),
    _cfg("qsgd-ring-watch", {"compressor": "qsgd", "quantum_num": 64,
                             "use_pallas": False, "memory": "none",
                             "communicator": "ring", "fusion": "flat",
                             "telemetry": True, "watch": 5}),
    _cfg("hier-watch", {"compressor": "topk", "compress_ratio": 0.01,
                        "topk_algorithm": "chunk", "memory": "residual",
                        "communicator": "hier", "slice_size": 4,
                        "fusion": "flat", "telemetry": True, "watch": 5}),
    # -- the adaptive ladder: every rung is a host branch of its own, and
    #    wire reconciliation is left out (the wire cost depends on the rung)
    _cfg("adapt-homoqsgd-ring",
         {"compressor": "homoqsgd", "quantum_num": 7, "memory": "residual",
          "communicator": "ring", "fusion": "flat", "escape": "fp16",
          "telemetry": True,
          "adapt": {"window": 5, "ladder": [{"quantum_num": 127}]}},
         passes=_NO_WIRE),
    _cfg("adapt-topk-hier",
         {"compressor": "topk", "compress_ratio": 0.01,
          "topk_algorithm": "chunk", "memory": "residual",
          "communicator": "hier", "slice_size": 4, "fusion": "flat",
          "escape": "fp16", "telemetry": True,
          "adapt": {"window": 5, "ladder": [{"compress_ratio": 0.04}]}},
         passes=_NO_WIRE),
    _cfg("adapt-guard-consensus",
         {"compressor": "topk", "compress_ratio": 0.05,
          "memory": "residual", "communicator": "allgather",
          "escape": "fp16", "telemetry": True, "consensus": True,
          "adapt": {"window": 5, "ladder": [{"compress_ratio": 0.2}]}},
         passes=_NO_WIRE, mode="train",
         guard={"fallback_after": 3, "fallback_steps": 8}, consensus=True),
    # -- the online re-tuner's two configs: the PowerSGD rank ladder (one
    #    padded state for every rung) and its incumbent
    _cfg("adapt-powersgd-rankladder",
         {"compressor": "powersgd", "compress_rank": 4,
          "memory": "powersgd", "communicator": "allreduce",
          "escape": "fp16", "telemetry": True,
          "adapt": {"window": 5, "ladder": [{"compress_rank": 1}]}},
         passes=_NO_WIRE),
    _cfg("retune-incumbent-homoqsgd",
         {"compressor": "homoqsgd", "quantum_num": 7, "memory": "residual",
          "communicator": "allreduce", "fusion": "flat", "escape": "fp16",
          "telemetry": True, "consensus": True},
         passes=_NO_WIRE, mode="train",
         guard={"fallback_after": 3, "fallback_steps": 8}, consensus=True),
    # -- resilience variants: the escape window, the guard and the audit
    _cfg("topk-escape-telemetry",
         {"compressor": "topk", "compress_ratio": 0.3, "memory": "residual",
          "communicator": "allgather", "escape": "fp16", "telemetry": True},
         passes=_NO_WIRE),
    _cfg("topk-guard-consensus",
         {"compressor": "topk", "compress_ratio": 0.3, "memory": "residual",
          "communicator": "allgather", "escape": "fp16", "telemetry": True,
          "consensus": True},
         passes=_NO_WIRE, mode="train",
         guard={"fallback_after": 3, "fallback_steps": 8}, consensus=True),
    _cfg("ring-guard-consensus",
         {"compressor": "qsgd", "quantum_num": 64, "use_pallas": False,
          "memory": "none", "communicator": "ring", "fusion": "flat",
          "escape": "fp16", "consensus": True},
         passes=_NO_WIRE, mode="train",
         guard={"fallback_after": 3, "fallback_steps": 8}, consensus=True),
    _cfg("hier-guard-consensus",
         {"compressor": "topk", "compress_ratio": 0.01,
          "topk_algorithm": "chunk", "memory": "residual",
          "communicator": "hier", "slice_size": 4, "fusion": "flat",
          "escape": "fp16", "consensus": True},
         passes=_NO_WIRE, mode="train",
         guard={"fallback_after": 3, "fallback_steps": 8}, consensus=True),
    _cfg("bucketed-guard-consensus",
         {"compressor": "topk", "compress_ratio": 0.3, "memory": "residual",
          "communicator": "allgather", "fusion": 1024, "escape": "fp16",
          "telemetry": True, "consensus": True},
         passes=_NO_WIRE, mode="train",
         guard={"fallback_after": 3, "fallback_steps": 8}, consensus=True),
    _cfg("homoqsgd-hier-guard-consensus",
         {"compressor": "homoqsgd", "quantum_num": 7, "memory": "residual",
          "communicator": "hier", "slice_size": 4, "fusion": "flat",
          "escape": "fp16", "consensus": True},
         passes=_NO_WIRE, mode="train",
         guard={"fallback_after": 3, "fallback_steps": 8}, consensus=True),
    _cfg("hier3-guard-consensus",
         {"compressor": "topk", "compress_ratio": 0.25,
          "topk_algorithm": "chunk", "memory": "residual",
          "communicator": "hier", "slice_size": 2, "region_size": 4,
          "fusion": "flat", "escape": "fp16", "consensus": True},
         passes=_NO_WIRE, mode="train",
         guard={"fallback_after": 3, "fallback_steps": 8}, consensus=True),
    _cfg("watch-guard-consensus",
         {"compressor": "topk", "compress_ratio": 0.3, "memory": "residual",
          "communicator": "allgather", "escape": "fp16", "telemetry": True,
          "watch": 5, "consensus": True},
         passes=_NO_WIRE, mode="train",
         guard={"fallback_after": 3, "fallback_steps": 8}, consensus=True),
    _cfg("rscatter-fsdp-routed-guard-consensus",
         {"compressor": "topk", "compress_ratio": 0.3, "memory": "residual",
          "communicator": "rscatter", "fsdp_axis": "fsdp",
          "route": [("b", {"compressor": "fp16", "memory": "none",
                           "communicator": "allreduce"})],
          "escape": "fp16", "consensus": True},
         passes=_NO_WIRE, mode="train", fsdp=2,
         guard={"fallback_after": 3, "fallback_steps": 8}, consensus=True),
]


# The tuner's variants (the JAX package's tuning.candidates
# variant_audit_entries): the bucketed executor over the two-level
# schedule, packed 4-bit wire through hier's requant points, the pipelined
# packed ring, the homomorphic rscatter and the three-tier WAN re-encode.
_TUNE_HIER = {"compressor": "topk", "compress_ratio": 0.01,
              "topk_algorithm": "chunk", "memory": "residual",
              "communicator": "hier", "slice_size": 4}
AUDIT_CONFIGS.extend([
    _cfg("tune-topk1pct-hier-bucketed", {**_TUNE_HIER, "fusion": 1024}),
    _cfg("tune-qsgd4-hier-packed",
         {"compressor": "qsgd", "quantum_num": 7, "use_pallas": False,
          "memory": "none", "communicator": "hier", "slice_size": 4,
          "fusion": "flat"}),
    _cfg("tune-qsgd4-ring-packed-pipelined",
         {"compressor": "qsgd", "quantum_num": 7, "use_pallas": False,
          "memory": "none", "communicator": "ring", "fusion": "flat",
          "pipeline": 2}),
    _cfg("tune-homoqsgd4-rscatter",
         {"compressor": "homoqsgd", "quantum_num": 7, "memory": "residual",
          "communicator": "rscatter", "fusion": "flat"}),
    _cfg("tune-topk1pct-hier3-wan",
         {"compressor": "topk", "compress_ratio": 0.25,
          "topk_algorithm": "chunk", "memory": "residual",
          "communicator": "hier", "slice_size": 2, "region_size": 4,
          "fusion": "flat",
          "wan_compressor": {"compressor": "topk", "compress_ratio": 0.05,
                             "topk_algorithm": "chunk"}}),
])


def model_param_structs(model: str):
    """``{name: (shape, dtype)}`` of ``model``'s parameters (``default``:
    the audit's own; ``resnet50``: ResNet-50 at 1000 classes)."""
    from grace_tpu_torch.analysis.trace import default_param_structs

    if model == "default":
        return default_param_structs()
    if model == "resnet50":
        from grace_tpu_torch.models.resnet import resnet50
        net = resnet50(1000, device="cpu")
        return {n: (tuple(p.shape), p.dtype)
                for n, p in net.named_parameters()}
    raise ValueError(f"unknown model {model!r}")


def build_grace(entry: Dict[str, Any]):
    """The Grace bundle of one registry entry, over the default group (a
    2-D entry's mesh names its axes only: :func:`audit_config` builds it
    over the fake world's mesh instead)."""
    from grace_tpu_torch.helper import grace_from_params
    return grace_from_params(dict(entry["params"]))


def _one_rank_diverged(read):
    """The audit's fingerprint matrix with the last rank's row apart from
    the others (the audit then repairs it); None (zeros) for any other
    read."""
    if read.site != "resilience/consensus.py:_audit" or len(read.shape) != 2:
        return None
    import numpy as np
    matrix = np.zeros(read.shape, dtype=np.int64)
    matrix[-1] = 1
    return matrix


def branches(entry: Dict[str, Any]) -> List[Branch]:
    """The host branches of one entry's step, each traced on its own: the
    base step; with an escape, the open window; with a ladder, every rung
    below the top and a step that reads a window boundary; with a watch,
    a step off its window; in train mode, an audit step and an audit that
    finds one rank diverged and repairs it (consensus). The guard's verdict
    is read (settled) by the audit, ahead of its gather."""
    params = entry["params"]
    train = entry.get("mode", "update") == "train"
    out = [Branch("base")]
    adapt = params.get("adapt")
    if params.get("escape"):
        out.append(Branch("fallback", fallback=True))
    if adapt:
        rungs = len(adapt.get("ladder", ())) + 1
        out += [Branch(f"rung{r}", rung=r) for r in range(1, rungs)]
        window = int(adapt.get("window", 1))
        out.append(Branch("window", count=window - 1, warmup=1))
    if params.get("watch"):
        out.append(Branch("off-window", count=1))
    if train and entry.get("consensus"):
        out.append(Branch("audit", audit=True))
        out.append(Branch("repair", audit=True, reads=_one_rank_diverged))
    return out


def trace_config(entry: Dict[str, Any], branch: Optional[Branch] = None, *,
                 world: int = 8, device: str = "cuda",
                 params=None, rank: int = 0) -> TracedGraph:
    """Trace one entry under one host branch (default: the base step) as
    ``rank``; ``params`` (``{name: (shape, dtype)}``) replaces the default
    audit parameters (a train trace's model then holds those leaves)."""
    world = int(entry.get("world") or world)
    meta = {"params": entry.get("params")}
    if params is not None:
        meta["param_structs"] = dict(params)
    if entry.get("mode", "update") == "train":
        return trace_train_step(
            dict(entry["params"]), world=world, guard=entry.get("guard"),
            consensus=entry.get("consensus"), name=entry["name"], meta=meta,
            fsdp=entry.get("fsdp"), device=device, branch=branch,
            rank=rank, params=params)
    return trace_update(dict(entry["params"]), world=world,
                        name=entry["name"], meta=meta,
                        fsdp=entry.get("fsdp"), device=device,
                        branch=branch, params=params, rank=rank)


def _trace_finding(entry, exc: Exception, branch: Branch) -> Finding:
    return Finding(
        pass_name="trace", config=entry["name"], severity="error",
        message=(f"config failed to trace on the fake world "
                 f"(branch {branch.label}): {type(exc).__name__}: {exc}"),
        details=(("branch", branch.label),))


def audit_traces(entry: Dict[str, Any], *, world: int = 8,
                 device: str = "cuda", params=None, rank: int = 0):
    """``(traces, findings)``: one entry's trace of every host branch and
    every finding of its passes over them (the same finding from two
    branches once). A branch that fails to trace is a ``trace`` finding
    (its message names the op or the check that stopped it)."""
    passes = tuple(entry.get("passes") or PASS_NAMES)
    traces, findings, seen = [], [], set()
    for branch in branches(entry):
        try:
            traced = trace_config(entry, branch, world=world, device=device,
                                  params=params, rank=rank)
        except Exception as e:                           # noqa: BLE001
            findings.append(_trace_finding(entry, e, branch))
            return traces, findings
        traces.append(traced)
        # The wire cost of an escape or a ladder config depends on the
        # branch: its wire model is reconciled on the base step alone.
        run = passes if branch.label == "base" else tuple(
            p for p in passes if p != "wire_reconciliation")
        for f in run_passes(traced, run):
            key = (f.pass_name, f.severity, f.message)
            if key not in seen:
                seen.add(key)
                findings.append(f)
    return traces, findings


def audit_config(entry: Dict[str, Any], *, world: int = 8,
                 device: str = "cuda") -> List[Finding]:
    """Trace one registry entry (or an ad-hoc ``{'name', 'params', ...}``
    dict) under every host branch and run its passes. Trace failures are
    findings, not exceptions."""
    return audit_traces(entry, world=world, device=device)[1]


def audit_all(configs: Optional[Sequence[Dict[str, Any]]] = None, *,
              world: int = 8, device: str = "cuda",
              progress=None) -> List[Finding]:
    """Audit every registry config; the concatenated findings."""
    findings: List[Finding] = []
    for entry in (configs if configs is not None else AUDIT_CONFIGS):
        if progress is not None:
            progress(entry["name"])
        findings.extend(audit_config(entry, world=world, device=device))
    return findings


def overlap_bound_report(entry: Dict[str, Any], *, world: int = 8,
                         device: str = "cuda") -> Optional[Dict[str, Any]]:
    """The static overlap bound and chain counts of one bucketed
    (``fusion=<int bytes>``) update-mode entry; None for the others."""
    from grace_tpu_torch.analysis import flow

    fusion = entry["params"].get("fusion")
    if entry.get("mode", "update") != "update" \
            or isinstance(fusion, bool) or not isinstance(fusion, int):
        return None
    world = int(entry.get("world") or world)
    traced = trace_config(entry, world=world, device=device)
    s = flow.overlap_summary(traced)
    bound = s["static_overlap_bound"]
    return {"static_overlap_bound": (round(bound, 6)
                                     if bound is not None else None),
            "independent_chains": int(s["independent_chains"]),
            "expected_chains": flow._expected_chains(traced),
            "exchange_collectives": int(s["exchange_collectives"]),
            "world": int(world)}
