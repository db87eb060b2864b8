"""String-keyed factory: ``grace_from_params``, counterpart of the JAX
package's ``helper.py`` for the keys and names this port carries.

The params-dict schema is the JAX package's, so its dicts (the benchmark's
``HEADLINE`` pair among them) build verbatim. A key or a name that the
port does not carry yet raises ``ValueError`` naming it, instead of being
dropped. ``world_size`` is accepted and ignored, as in the JAX package:
the world is the process group's. The process group itself is passed as
``group=`` (the JAX package's ``axis_name``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from grace_tpu_torch import comm
from grace_tpu_torch import compressors as C
from grace_tpu_torch import memories as M
from grace_tpu_torch.core import Communicator, Compressor, Memory
from grace_tpu_torch.transform import GraceTransform, grace_transform

# Keys of the JAX schema that this port reads.
PORTED_KEYS = frozenset({
    "compressor", "compress_ratio", "topk_algorithm", "wire_dtype",
    "use_pallas", "quantum_num", "accum_dtype", "accum_bits", "sketch_rows",
    "momentum", "memory", "beta", "gamma", "memory_dtype", "communicator",
    "pipeline", "vote_dtype", "fusion", "world_size"})


def _unsupported(kind: str, name, ported) -> ValueError:
    return ValueError(f"{kind} {name!r} is not ported to grace_tpu_torch "
                      f"(ported: {list(ported)}; the rest of the JAX "
                      "package's catalog is queued in ROADMAP queue 1)")


@dataclasses.dataclass(frozen=True)
class Grace:
    """The configured triad; ``.transform(seed)`` builds the executor."""

    compressor: Compressor
    memory: Memory
    communicator: Communicator
    fusion: Optional[str] = None

    def transform(self, seed: int = 0) -> GraceTransform:
        return grace_transform(self.compressor, self.memory,
                               self.communicator, seed=seed,
                               fusion=self.fusion)


def _build_compressor(params: Dict[str, Any]) -> Compressor:
    name = params.get("compressor", "none")
    if name == "none":
        return C.NoneCompressor()
    if name == "topk":
        return C.TopKCompressor(
            compress_ratio=params.get("compress_ratio", 0.3),
            algorithm=params.get("topk_algorithm", "exact"),
            wire_dtype=params.get("wire_dtype", "float32"),
            use_pallas=params.get("use_pallas", "auto"))
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
    if name == "signsgd":
        return C.SignSGDCompressor(use_pallas=params.get("use_pallas",
                                                         "auto"))
    if name == "signum":
        return C.SignumCompressor(momentum=params.get("momentum", 0.9),
                                  use_pallas=params.get("use_pallas",
                                                        "auto"))
    raise _unsupported("compressor", name,
                       ("none", "topk", "qsgd", "homoqsgd", "countsketch",
                        "signsgd", "signum"))


def _build_memory(params: Dict[str, Any]) -> Memory:
    name = params.get("memory", "none")
    if name == "none":
        return M.NoneMemory()
    if name == "residual":
        return M.ResidualMemory(
            beta=params.get("beta", 1.0), gamma=params.get("gamma", 1.0),
            state_dtype=params.get("memory_dtype"))
    raise _unsupported("memory", name, ("none", "residual"))


def _build_communicator(params: Dict[str, Any], group) -> Communicator:
    name = params.get("communicator", "allgather")
    if name == "allreduce":
        return comm.Allreduce(group=group,
                              vote_dtype=params.get("vote_dtype", "bfloat16"))
    if name == "allgather":
        return comm.Allgather(group=group)
    if name == "broadcast":
        return comm.Broadcast(group=group)
    if name in ("ring", "ring_allreduce"):
        return comm.RingAllreduce(group=group,
                                  pipeline=int(params.get("pipeline", 1)))
    if name in ("rscatter", "reduce_scatter", "rscatter_allreduce"):
        return comm.ReduceScatterAllreduce(group=group)
    if name in ("sign_allreduce", "signallreduce"):
        return comm.SignAllreduce(
            group=group, vote_dtype=params.get("vote_dtype", "bfloat16"))
    if name in ("identity", "none"):
        return comm.Identity(group=group)
    raise _unsupported("communicator", name,
                       ("allreduce", "allgather", "broadcast", "ring",
                        "rscatter", "sign_allreduce", "identity"))


def grace_from_params(params: Dict[str, Any], group: Optional[Any] = None
                      ) -> Grace:
    """Configure the triad from the JAX package's params-dict schema."""
    unported = sorted(set(params) - PORTED_KEYS)
    if unported:
        raise ValueError(f"params keys not ported to grace_tpu_torch yet: "
                         f"{unported} (ROADMAP queue 1)")
    fusion = params.get("fusion")
    if fusion in ("none", "None", ""):     # CLI spelling of "no fusion"
        fusion = None
    if fusion is not None and fusion != "flat":
        raise _unsupported("fusion", fusion, (None, "none", "flat"))
    return Grace(compressor=_build_compressor(params),
                 memory=_build_memory(params),
                 communicator=_build_communicator(params, group),
                 fusion=fusion)
