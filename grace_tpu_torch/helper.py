"""String-keyed factory: ``grace_from_params``, counterpart of the JAX
package's ``helper.py``.

The params-dict schema is the JAX package's, so its dicts (the benchmark's
``HEADLINE`` pair among them) build verbatim: every codec name and memory
name, with the JAX defaults, every ``fusion`` setting (None, ``'flat'``,
``'grouped'``, bucket bytes), per-leaf ``route`` tables and the
resilience and observability keys ``escape``, ``telemetry``, ``consensus``,
``watch`` and ``adapt`` (their configurations validated here, with the JAX
package's errors; ``watch`` without ``telemetry`` and ``adapt`` without
``escape`` or ``telemetry`` raise at ``.transform()``, as in JAX), and
``fsdp_axis``, the 2-D dp×fsdp layout. An unknown key or name raises
``ValueError`` naming it, instead of being dropped. PowerSGD's and the DGC
memory's collectives run over the ``group`` given here. ``world_size`` is
accepted and ignored, as in the JAX package: the world is the process
group's. The process group itself is passed as ``group=`` (the JAX
package's ``axis_name``); on a 2-D mesh pass the mesh
(``parallel.make_mesh``): the communicator, PowerSGD and the DGC memory
then run over its dp group, and ``Grace.mesh`` carries it::

    mesh = make_mesh((4, 2), ("data", "fsdp"))
    grc = grace_from_params({"compressor": "topk", "compress_ratio": 0.3,
                             "memory": "residual", "communicator": "rscatter",
                             "fsdp_axis": "fsdp"}, group=mesh)

An adaptive ladder names its rungs as override dicts merged over the
config's own params, safest first; the config's own codec is the top rung::

    {"compressor": "topk", "compress_ratio": 0.01,
     "topk_algorithm": "chunk", "memory": "residual",
     "communicator": "allgather", "escape": "fp16", "telemetry": True,
     "adapt": {"window": 5, "ladder": [{"compress_ratio": 0.04}]}}

A hierarchical run names its layout and, for three levels, its WAN codec
as a nested params dict::

    {"compressor": "topk", "compress_ratio": 0.01,
     "topk_algorithm": "chunk", "memory": "residual",
     "communicator": "hier", "slice_size": 8, "region_size": 32,
     "wan_compressor": {"compressor": "topk", "compress_ratio": 0.001},
     "fusion": "flat"}
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

from grace_tpu_torch import comm
from grace_tpu_torch import compressors as C
from grace_tpu_torch import memories as M
from grace_tpu_torch.core import (Communicator, Compressor, LinkBytes, Memory,
                                  Topology, negotiation_bytes_for)
from grace_tpu_torch.resilience.consensus import normalize_consensus
from grace_tpu_torch.telemetry.aggregate import normalize_watch
from grace_tpu_torch.transform import (GraceTransform, MeshSpec,
                                       _normalize_telemetry, _struct,
                                       check_fusion, grace_transform,
                                       leaf_order, leaf_path_str,
                                       normalize_routes, route_for)

# Keys of the JAX schema that this port reads.
PORTED_KEYS = frozenset({
    "compressor", "compress_ratio", "topk_algorithm", "wire_dtype",
    "use_pallas", "quantum_num", "accum_dtype", "accum_bits", "sketch_rows",
    "momentum", "memory", "beta", "gamma", "memory_dtype", "communicator",
    "pipeline", "vote_dtype", "fusion", "stage2_feedback", "world_size",
    "slice_size", "region_size", "wan_compressor", "compress_rank",
    "threshold", "capacity_ratio", "lr", "gradient_clipping",
    "recall_target", "route", "escape", "telemetry", "consensus",
    "watch", "adapt", "fsdp_axis"})

COMPRESSORS = ("none", "fp16", "bf16", "bfloat16", "cyclictopk", "topk",
               "randomk", "threshold", "qsgd", "homoqsgd", "countsketch",
               "terngrad", "signsgd", "signum", "efsignsgd", "onebit",
               "natural", "dgc", "powersgd", "u8bit", "sketch", "adaq",
               "inceptionn")
MEMORIES = ("none", "residual", "efsignsgd", "dgc", "powersgd")


def _unsupported(kind: str, name, ported) -> ValueError:
    return ValueError(f"unknown {kind} {name!r} (grace_tpu_torch builds: "
                      f"{list(ported)})")


@dataclasses.dataclass(frozen=True)
class Grace:
    """The configured triad; ``.transform(seed)`` builds the executor.

    ``topology`` is the link layout that ``slice_size`` and ``region_size``
    declare (None when neither is given: the telemetry ring then prices
    its per-link split under the detected layout), the JAX package's
    ``Grace`` field. ``routes`` is the normalized per-leaf routing table
    (``((pattern, compressor, memory, communicator), ...)``) that
    ``params["route"]`` builds. ``escape`` is the dense codec of the
    guard's fallback window (None: no escape) and ``telemetry`` the ring's
    setting (None, True, a capacity, a dict or a ``TelemetryConfig``).
    ``consensus`` is the audit's ``ConsensusConfig`` (None: off): the
    transform carries an ``AuditState``, and the same value goes to
    ``train.make_train_step(consensus=...)`` for the hook. ``watch`` is
    the cross-rank watch ring's ``WatchConfig`` (None: off). ``adapt`` is
    the adaptive ladder's ``AdaptConfig`` with its built rung codecs, the
    base codec on top (None: off). ``mesh`` is the 2-D
    :class:`~grace_tpu_torch.transform.MeshSpec` that ``fsdp_axis`` declares
    (None: pure data parallelism over the communicator's group)."""

    compressor: Compressor
    memory: Memory
    communicator: Communicator
    fusion: Any = None        # None | 'flat' | 'grouped' | bucket bytes
    topology: Optional[Topology] = None
    routes: Tuple = ()
    escape: Optional[Compressor] = None
    telemetry: Any = None
    consensus: Any = None
    watch: Any = None
    adapt: Any = None
    mesh: Any = None

    def transform(self, seed: int = 0) -> GraceTransform:
        return grace_transform(self.compressor, self.memory,
                               self.communicator, seed=seed,
                               fusion=self.fusion,
                               routes=self.routes or None,
                               escape=self.escape, telemetry=self.telemetry,
                               topology=self.topology,
                               consensus=self.consensus, watch=self.watch,
                               adapt=self.adapt, mesh=self.mesh)


def _pad_powersgd_states(base: Compressor, rungs: Tuple[Compressor, ...]
                         ) -> Tuple[Compressor, Tuple[Compressor, ...]]:
    """The rung-invariant PowerSGD layout of an adaptive ladder: every
    PowerSGD codec among the rungs and the base (the top rung, whose state
    the transform allocates) stores Q at the ladder's largest rank
    (``state_rank``), so every rung keeps one state structure. Ladders
    without PowerSGD, or without rungs, come back as they were."""
    ps = [c for c in (*rungs, base) if isinstance(c, C.PowerSGDCompressor)]
    if not ps or not rungs:
        return base, tuple(rungs)
    pad = max(c.state_rank or c.rank for c in ps)

    def fix(c):
        if isinstance(c, C.PowerSGDCompressor) and c.state_rank != pad:
            return dataclasses.replace(c, state_rank=pad)
        return c

    return fix(base), tuple(fix(c) for c in rungs)


def _build_adapt(params: Dict[str, Any], compressor: Compressor, group):
    """``(compressor, AdaptConfig)`` of ``params["adapt"]``: True, a
    window, a dict whose ``ladder`` holds override dicts (each merged over
    these params less ``adapt`` and ``route``, built into one rung codec),
    or an AdaptConfig with built codecs. PowerSGD rungs and the base are
    padded to one Q layout (:func:`_pad_powersgd_states`)."""
    from grace_tpu_torch.resilience.adapt import AdaptConfig, normalize_adapt

    spec = params["adapt"]
    if isinstance(spec, AdaptConfig):
        compressor, ladder = _pad_powersgd_states(compressor,
                                                  tuple(spec.ladder))
        if ladder != tuple(spec.ladder):
            spec = dataclasses.replace(spec, ladder=ladder)
        return compressor, normalize_adapt(spec, compressor)
    if spec is True:
        kwargs: Dict[str, Any] = {}
    elif isinstance(spec, int):
        kwargs = {"window": spec}
    elif isinstance(spec, dict):
        kwargs = dict(spec)
    else:
        raise TypeError(f"adapt must be True/int/dict/AdaptConfig; got "
                        f"{type(spec).__name__}")
    rungs = []
    for overrides in kwargs.pop("ladder", ()):
        merged = {k: v for k, v in params.items()
                  if k not in ("adapt", "route")}
        merged.update(dict(overrides))
        rungs.append(_build_compressor(merged, group))
    compressor, rungs = _pad_powersgd_states(compressor, tuple(rungs))
    return compressor, normalize_adapt(AdaptConfig(ladder=rungs, **kwargs),
                                       compressor)


def _build_compressor(params: Dict[str, Any], group=None) -> Compressor:
    name = params.get("compressor", "none")
    ratio = params.get("compress_ratio", 0.3)
    if name == "none":
        return C.NoneCompressor()
    if name in ("fp16", "bf16", "bfloat16"):
        return C.FP16Compressor(dtype="float16" if name == "fp16"
                                else "bfloat16")
    if name == "cyclictopk":
        return C.CyclicTopKCompressor(compress_ratio=ratio)
    if name == "topk":
        return C.TopKCompressor(
            compress_ratio=ratio,
            algorithm=params.get("topk_algorithm", "exact"),
            recall_target=params.get("recall_target", 0.95),
            wire_dtype=params.get("wire_dtype", "float32"),
            use_pallas=params.get("use_pallas", "auto"))
    if name == "randomk":
        return C.RandomKCompressor(compress_ratio=ratio)
    if name == "threshold":
        return C.ThresholdCompressor(
            threshold=params.get("threshold", 0.01),
            capacity_ratio=params.get("capacity_ratio", 0.25))
    if name == "qsgd":
        return C.QSGDCompressor(quantum_num=params.get("quantum_num", 64),
                                use_pallas=params.get("use_pallas", "auto"))
    if name == "homoqsgd":
        return C.HomoQSGDCompressor(
            quantum_num=params.get("quantum_num", 7),
            accum_dtype=params.get("accum_dtype", "int16"),
            accum_bits=params.get("accum_bits"),
            use_pallas=params.get("use_pallas", "auto"))
    if name == "countsketch":
        return C.CountSketchCompressor(
            compress_ratio=params.get("compress_ratio", 0.25),
            rows=params.get("sketch_rows", 3))
    if name == "terngrad":
        return C.TernGradCompressor()
    if name == "signsgd":
        return C.SignSGDCompressor(use_pallas=params.get("use_pallas",
                                                         "auto"))
    if name == "signum":
        return C.SignumCompressor(momentum=params.get("momentum", 0.9),
                                  use_pallas=params.get("use_pallas",
                                                        "auto"))
    if name == "efsignsgd":
        return C.EFSignSGDCompressor(lr=params.get("lr", 0.1))
    if name == "onebit":
        return C.OneBitCompressor()
    if name == "natural":
        return C.NaturalCompressor()
    if name == "dgc":
        return C.DgcCompressor(compress_ratio=params.get("compress_ratio",
                                                         0.01))
    if name == "powersgd":
        # Its two all-reduces run inside compress, over the group.
        return C.PowerSGDCompressor(rank=params.get("compress_rank", 1),
                                    group=group)
    if name == "u8bit":
        return C.U8bitCompressor()
    if name == "sketch":
        return C.SketchCompressor(bins=params.get("quantum_num", 256))
    if name == "adaq":
        return C.AdaqCompressor(compress_ratio=params.get("compress_ratio",
                                                          0.01))
    if name == "inceptionn":
        return C.InceptionNCompressor()
    raise _unsupported("compressor", name, COMPRESSORS)


def _build_memory(params: Dict[str, Any], group=None) -> Memory:
    name = params.get("memory", "none")
    if name == "none":
        return M.NoneMemory()
    if name == "residual":
        return M.ResidualMemory(
            beta=params.get("beta", 1.0), gamma=params.get("gamma", 1.0),
            state_dtype=params.get("memory_dtype"))
    if name == "efsignsgd":
        return M.EFSignSGDMemory(lr=params.get("lr", 0.1))
    if name == "dgc":
        # The gradient clipping's all-reduce runs over the group.
        return M.DgcMemory(momentum=params.get("momentum", 0.9),
                           gradient_clipping=params.get("gradient_clipping",
                                                        False),
                           group=group)
    if name == "powersgd":
        return M.PowerSGDMemory()
    raise _unsupported("memory", name, MEMORIES)


def _build_escape(escape) -> Optional[Compressor]:
    """The escape codec a params dict names: ``"none"``/``"dense"`` (the
    identity), ``"fp16"``, ``"bf16"``/``"bfloat16"``, or a compressor
    object as it is."""
    if not isinstance(escape, str):
        return escape
    if escape in ("none", "dense"):
        return C.NoneCompressor()
    if escape in ("fp16", "bf16", "bfloat16"):
        return C.FP16Compressor(dtype="float16" if escape == "fp16"
                                else "bfloat16")
    raise ValueError(f"unknown escape compressor {escape!r} — use "
                     "'none'/'dense', 'fp16', or 'bf16'")


def _build_communicator(params: Dict[str, Any], group) -> Communicator:
    name = params.get("communicator", "allgather")
    if name == "allreduce":
        return comm.Allreduce(group=group,
                              vote_dtype=params.get("vote_dtype", "bfloat16"))
    if name == "allgather":
        return comm.Allgather(group=group)
    if name == "broadcast":
        return comm.Broadcast(group=group)
    if name in ("twoshot", "twoshot_allreduce"):
        return comm.TwoShotAllreduce(
            group=group,
            stage2_feedback=bool(params.get("stage2_feedback", False)))
    if name in ("ring", "ring_allreduce"):
        return comm.RingAllreduce(group=group,
                                  pipeline=int(params.get("pipeline", 1)))
    if name in ("rscatter", "reduce_scatter", "rscatter_allreduce"):
        return comm.ReduceScatterAllreduce(group=group)
    if name in ("hier", "hierarchical", "hier_allreduce"):
        # wan_compressor is a nested params dict naming the cross-region
        # codec.
        wan_params = params.get("wan_compressor")
        wan = (_build_compressor(dict(wan_params), group)
               if isinstance(wan_params, dict) else None)
        return comm.HierarchicalAllreduce(
            group=group, slice_size=params.get("slice_size"),
            region_size=params.get("region_size"), wan_compressor=wan,
            pipeline=int(params.get("pipeline", 1)))
    if name in ("sign_allreduce", "signallreduce"):
        return comm.SignAllreduce(
            group=group, vote_dtype=params.get("vote_dtype", "bfloat16"))
    if name in ("identity", "none"):
        return comm.Identity(group=group)
    raise _unsupported("communicator", name,
                       ("allreduce", "allgather", "broadcast", "twoshot",
                        "ring", "rscatter", "hier", "sign_allreduce",
                        "identity"))


def grace_from_params(params: Dict[str, Any], group: Optional[Any] = None
                      ) -> Grace:
    """Configure the triad from the JAX package's params-dict schema.

    ``fusion`` is None, ``'flat'``, ``'grouped'`` or an integer count of
    bucket bytes (``transform.grace_transform``). ``route`` is
    ``[(pattern, overrides), ...]``: each ``overrides`` dict is merged over
    this config's own params (minus the route itself) and built into a
    whole sub-triad; ``pattern`` is an fnmatch glob over the leaf's
    ``"/"``-joined path (``transform.leaf_path_str``). First match wins;
    unmatched leaves ride the base triad. Routes need ``fusion=None``. For
    example, BatchNorm leaves sent dense::

        {"compressor": "topk", "compress_ratio": 0.01,
         "topk_algorithm": "chunk", "memory": "residual",
         "communicator": "allgather",
         "route": [("*bn*", {"compressor": "fp16", "memory": "none",
                             "communicator": "allreduce"})]}

    ``fsdp_axis`` names the mesh axis that parameters and optimizer state
    shard over: the 2-D dp×fsdp layout (``transform.MeshSpec``), whose
    exchange stays the per-shard reduce over the dp axis. ``group`` may
    then be a mesh from ``parallel.make_mesh``: the communicator, the
    routes' and the ladder's, PowerSGD and the DGC memory run over its dp
    group, and ``Grace.mesh`` is the mesh (the guard ORs its verdict over
    all of it). Without a mesh the spec names the axes only and the
    groups are the ones given.
    """
    unported = sorted(set(params) - PORTED_KEYS)
    if unported:
        raise ValueError(f"params keys not ported to grace_tpu_torch yet: "
                         f"{unported} (ROADMAP queue 1)")
    mesh = None
    if isinstance(group, MeshSpec):
        mesh, group = group, group.dp_group
    fsdp_axis = params.get("fsdp_axis")
    if fsdp_axis:
        if mesh is None:
            mesh = MeshSpec(fsdp_axis=str(fsdp_axis))
        elif mesh.fsdp_axis != fsdp_axis:
            raise ValueError(
                f"fsdp_axis {fsdp_axis!r} differs from the mesh's "
                f"{mesh.fsdp_axis!r}")
    elif mesh is not None and not mesh.is_2d:
        mesh = None                    # a 1-D mesh: its group alone
    fusion = params.get("fusion")
    if fusion in ("none", "None", ""):     # CLI spelling of "no fusion"
        fusion = None
    check_fusion(fusion, bool(params.get("route")))
    communicator = _build_communicator(params, group)
    routes: Tuple = ()
    if params.get("route"):
        entries = []
        for pattern, overrides in params["route"]:
            merged = {k: v for k, v in params.items() if k != "route"}
            merged.update(dict(overrides))
            entries.append((str(pattern), grace_from_params(
                merged, group if mesh is None else mesh)))
        routes = normalize_routes(entries, communicator)
    slice_size, region_size = params.get("slice_size"), \
        params.get("region_size")
    topology = (Topology(
        slice_size=int(slice_size) if slice_size else None,
        region_size=int(region_size) if region_size else None)
        if (slice_size or region_size) else None)
    compressor, adapt = _build_compressor(params, group), None
    if params.get("adapt"):
        compressor, adapt = _build_adapt(params, compressor, group)
    return Grace(compressor=compressor,
                 memory=_build_memory(params, group),
                 communicator=communicator,
                 fusion=fusion, topology=topology, routes=routes,
                 escape=_build_escape(params.get("escape")),
                 telemetry=_normalize_telemetry(params.get("telemetry")),
                 consensus=normalize_consensus(params.get("consensus")),
                 watch=normalize_watch(params.get("watch")),
                 adapt=adapt, mesh=mesh)


def route_leaves(grace: Grace, tree: Mapping[str, Any]) -> list:
    """Each leaf's route in leaf order: ``[(path, (shape, dtype),
    compressor, memory, communicator), ...]`` for a mapping of dotted names
    to tensors or ``(shape, dtype)`` pairs."""
    base = (grace.compressor, grace.memory, grace.communicator)
    out = []
    for name in leaf_order(tree):
        path = leaf_path_str(name)
        comp, mem, cm = route_for(grace.routes or (), path, base)
        out.append((path, _struct(tree[name]), comp, mem, cm))
    return out


def routed_recv_link_bytes(grace: Grace, tree: Mapping[str, Any], world: int,
                           topology: Optional[Topology] = None) -> LinkBytes:
    """One rank's received bytes of one routed step, by link class: the sum
    of every leaf's price through its own codec and communicator, the
    negotiation collectives included (on the worst tier the group spans).
    Unrouted bundles price every leaf through the base triad. Equal to the
    JAX package's integers."""
    from grace_tpu_torch.utils.metrics import payload_nbytes

    topo = topology if topology is not None else Topology()
    ici = dcn = wan = 0
    for _path, s, comp, _mem, cm in route_leaves(grace, tree):
        ne = math.prod(s[0])
        vote = bool(getattr(comp, "vote_aggregate", False))
        lb = cm.recv_link_bytes(payload_nbytes(comp, s), ne, world,
                                topology=topology, vote=vote)
        neg = negotiation_bytes_for(comp, ne, world)
        if neg:
            tier = topo.flat_tier(world)
            lb = lb._replace(**{tier: getattr(lb, tier) + neg})
        ici += lb.ici
        dcn += lb.dcn
        wan += lb.wan
    return LinkBytes(ici=ici, dcn=dcn, wan=wan)
