"""The tuner's cost model: a wire-dominated step-time projection;
counterpart of the JAX package's ``tuning/cost.py``, with its rule and
the port's own constants.

One pricing rule, stamped into every document the tuner writes:

    projected_step = base_compute_step + ici_bytes / ICI_BW
                     + dcn_bytes / DCN_BW + wan_bytes / WAN_BW

where ``(ici_bytes, dcn_bytes, wan_bytes)`` is
:meth:`Communicator.recv_link_bytes` under the *target*
:class:`~grace_tpu_torch.core.Topology`: the per-link wire model the
telemetry ring and the static auditor's ``wire_reconciliation`` agree on.
On GPUs the tiers are NVLink within a node (``ici``), the inter-node
network (``dcn``) and the cross-region link (``wan``).

The bandwidths are :data:`PROJECTION_MODEL`'s: published H100 SXM5 /
DGX H100 figures, model assumptions and not measurements, stated here
once. The JAX package prices its tiers at TPU v5e figures; no TPU rate is
the port's. :func:`price_candidate` and :func:`adapt_rung_prices` take
``constants=(ici, dcn, wan)`` to price with other figures (the tests pass
the JAX package's, to hold the port's rankings against JAX's).

The legs are priced apart because the schedules differ exactly there: a
flat communicator whose group crosses a node boundary receives every byte
over the slowest link it spans, where the hierarchical one keeps its
``2·k·(S−1)/S`` intra-node legs on NVLink and sends ``(K/R−1)·k/S``
across the network.

Model limits (recorded in the document, enforced by the measured stage):

* **wire-dominated**: the static stage prices every candidate at the
  same base compute step; codec compute (selection, quantisation, the
  kernels) is not modelled — the measured shortlist supplies it;
* **no overlap**, with one declared exception: a double-buffered
  communicator (``pipeline=P`` on the ring or hier) advertises
  ``wire_overlap_fraction()`` and its wire leg is discounted by exactly
  that factor; flow pass 5 referees the claim statically (≥ P independent
  compress→exchange chains in the traced step). Everything else keeps the
  no-overlap upper bound.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

__all__ = ["ICI_BYTES_PER_S", "DCN_BYTES_PER_S", "WAN_BYTES_PER_S",
           "PROJECTION_MODEL", "TuneTopology", "projection_constants",
           "dense_bytes", "n_elements", "price_candidate",
           "adapt_rung_prices"]

# NVLink 4 on an H100 SXM5: 18 links × 25 GB/s = 450 GB/s per direction
# per GPU within a node (NVIDIA H100 data sheet).
ICI_BYTES_PER_S = 4.5e11
# 400 Gb/s NDR InfiniBand, one ConnectX-7 a GPU on a DGX H100: 50 GB/s per
# GPU between nodes (DGX H100 user guide).
DCN_BYTES_PER_S = 5.0e10
# Cross-region: ~0.25 GB/s of sustained collective bandwidth a rank, a
# model assumption (~200x below the node network), not a card figure.
WAN_BYTES_PER_S = 2.5e8

PROJECTION_MODEL = {
    "ici_bytes_per_s": ICI_BYTES_PER_S,
    "dcn_bytes_per_s": DCN_BYTES_PER_S,
    "wan_bytes_per_s": WAN_BYTES_PER_S,
    "constants_source": (
        "MODEL ASSUMPTIONS from published figures, not measurements: "
        "NVIDIA H100 SXM5 NVLink 4, 18 links x 25 GB/s = 450 GB/s per "
        "direction per GPU within a node (H100 data sheet); 400 Gb/s NDR "
        "InfiniBand, one ConnectX-7 per GPU = 50 GB/s per GPU between "
        "nodes (DGX H100 user guide); WAN ~0.25 GB/s per rank of sustained "
        "cross-region collective bandwidth, an assumption, not a card "
        "figure."),
    "assumption": (
        "NO-OVERLAP upper bound on wire cost: projected_step = "
        "base_compute_step + ici/ICI_BW + dcn/DCN_BW + wan/WAN_BW, except "
        "a pipelined communicator's declared wire_overlap_fraction, which "
        "flow pass 5 referees."),
}


def projection_constants(constants: Optional[Tuple[float, float, float]]
                         = None) -> Tuple[float, float, float, dict]:
    """``(ici_bytes_per_s, dcn_bytes_per_s, wan_bytes_per_s, model)``:
    ``constants`` when given (``model`` then says so), else
    :data:`PROJECTION_MODEL`'s."""
    if constants is None:
        return (ICI_BYTES_PER_S, DCN_BYTES_PER_S, WAN_BYTES_PER_S,
                PROJECTION_MODEL)
    ici, dcn, wan = (float(c) for c in constants)
    return ici, dcn, wan, {
        "ici_bytes_per_s": ici, "dcn_bytes_per_s": dcn,
        "wan_bytes_per_s": wan,
        "constants_source": "given by the caller",
        "assumption": PROJECTION_MODEL["assumption"]}


@dataclasses.dataclass(frozen=True)
class TuneTopology:
    """The tuner's target mesh: the exchange (dp) world, the node width
    (``slice_size``, the fast-link domain), an optional region width and
    fsdp width. Parsed from ``W``, ``W,slice_size[,region_size]`` or
    ``dp×fsdp[,slice_size[,region_size]]`` (``64x4,8``: dp=64 × fsdp=4 in
    nodes of 8). ``world`` is the dp axis, the span every wire and numeric
    model prices; ``fsdp`` multiplies the devices without widening any
    priced collective. The JAX package's class."""

    world: int
    slice_size: Optional[int] = None
    fsdp: Optional[int] = None
    region_size: Optional[int] = None

    def __post_init__(self):
        if self.world < 1:
            raise ValueError(f"world must be >= 1; got {self.world}")
        if self.slice_size is not None and self.slice_size < 1:
            raise ValueError(
                f"slice_size must be >= 1 or None; got {self.slice_size}")
        if self.fsdp is not None and self.fsdp < 1:
            raise ValueError(f"fsdp must be >= 1 or None; got {self.fsdp}")
        if self.region_size is not None and self.slice_size is None:
            raise ValueError(
                "region_size requires slice_size — the WAN tier nests "
                "outside the slice tier")
        if self.region_size is not None and (
                self.region_size < 1
                or self.region_size % self.slice_size != 0):
            raise ValueError(
                f"region_size {self.region_size} must be a whole multiple "
                f"of slice_size {self.slice_size} — regions are made of "
                "whole slices")

    @classmethod
    def parse(cls, text: str) -> "TuneTopology":
        parts = [p.strip() for p in str(text).split(",") if p.strip()]
        if not parts or len(parts) > 3:
            raise ValueError(
                f"topology spec {text!r} is not 'W', "
                "'W,slice_size[,region_size]', or "
                "'DPxFSDP[,slice_size[,region_size]]'")
        head = parts[0].lower().replace("×", "x")
        if "x" in head:
            dp_s, fsdp_s = head.split("x", 1)
            world, fsdp = int(dp_s), int(fsdp_s)
        else:
            world, fsdp = int(head), None
        slice_size = int(parts[1]) if len(parts) >= 2 else None
        region_size = int(parts[2]) if len(parts) == 3 else None
        return cls(world=world, slice_size=slice_size, fsdp=fsdp,
                   region_size=region_size)

    def core_topology(self):
        from grace_tpu_torch.core import Topology
        return Topology(slice_size=self.slice_size,
                        region_size=self.region_size)

    @property
    def devices(self) -> int:
        """Total device count: dp × fsdp."""
        return self.world * (self.fsdp or 1)

    @property
    def label(self) -> str:
        w = (f"W{self.world}" if self.fsdp is None
             else f"W{self.world}x{self.fsdp}")
        if self.slice_size is None:
            return w
        if self.region_size is None:
            return f"{w}/slice{self.slice_size}"
        return f"{w}/slice{self.slice_size}/region{self.region_size}"


def _structs(model_structs) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """``{name: (shape, dtype)}`` of a parameter mapping (structs or
    tensors)."""
    from grace_tpu_torch.utils.metrics import _struct
    return {k: _struct(v) for k, v in model_structs.items()}


def dense_bytes(model_structs) -> int:
    """Dense gradient bytes of a parameter mapping."""
    return sum(math.prod(s) * d.itemsize
               for s, d in _structs(model_structs).values())


def n_elements(model_structs) -> int:
    return sum(math.prod(s) for s, _d in _structs(model_structs).values())


@functools.lru_cache(maxsize=None)
def _leaf_payload_bytes(compressor, shape, dtype) -> int:
    from grace_tpu_torch.utils.metrics import payload_nbytes
    return payload_nbytes(compressor, (shape, dtype))


def _payload_bytes(compressor, structs) -> int:
    """One rank's payload bytes over the leaves (``utils.wire_report``'s
    total), each distinct (codec, leaf shape) encoded once a process: the
    funnel prices many candidates that share a codec, and an encode of a
    model's largest leaf costs milliseconds on the CPU."""
    try:
        hash(compressor)
    except TypeError:
        from grace_tpu_torch.utils.metrics import wire_report
        return wire_report(compressor, structs).wire_bytes
    return sum(_leaf_payload_bytes(compressor, s, d)
               for s, d in structs.values())


def _wire_s(link, ici_bw: float, dcn_bw: float, wan_bw: float) -> float:
    return link.ici / ici_bw + link.dcn / dcn_bw + link.wan / wan_bw


def price_candidate(grace, model_structs, spec: TuneTopology, *,
                    base_step_s: float = 0.0,
                    dense_step_s: Optional[float] = None,
                    constants: Optional[Tuple[float, float, float]] = None
                    ) -> Dict[str, Any]:
    """One candidate's static price under the target topology (the JAX
    package's record). ``base_step_s`` is the compute step assumed for
    every candidate (0.0: pure wire ranking; the measured stage passes each
    candidate's own timed step); ``dense_step_s`` defaults to it. Dense
    rides a ring all-reduce priced through the same model."""
    from grace_tpu_torch.comm import Allreduce
    from grace_tpu_torch.transform import fusion_payload_structs, leaf_order

    ici_bw, dcn_bw, wan_bw, _ = projection_constants(constants)
    structs = _structs(model_structs)
    dense_step_s = base_step_s if dense_step_s is None else dense_step_s
    wire_b = _payload_bytes(grace.compressor, structs)
    n = n_elements(structs)
    dense_b = dense_bytes(structs)
    vote = bool(getattr(grace.compressor, "vote_aggregate", False))
    topo = spec.core_topology()
    link = grace.communicator.recv_link_bytes(
        wire_b, n, spec.world, topology=topo, vote=vote)
    # The shared-scale negotiation: one flat full-axis collective a
    # compress call of the fusion plan, priced at the slowest tier the
    # axis spans (0 for every other codec).
    n_calls = sum(count for _, count in fusion_payload_structs(
        [structs[k] for k in leaf_order(structs)], grace.fusion))
    neg_b = n_calls * int(grace.compressor.negotiation_nbytes(spec.world))
    if neg_b:
        tier = topo.flat_tier(spec.world)
        link = link._replace(**{tier: getattr(link, tier) + neg_b})
    dense_link = Allreduce(group=grace.communicator.group).recv_link_bytes(
        dense_b, n, spec.world, topology=topo)
    # The communicator's own declared overlap (the pipelined ring and hier
    # only); dense rides the flat, undiscounted all-reduce.
    overlap = float(getattr(grace.communicator, "wire_overlap_fraction",
                            lambda: 0.0)())
    wire_s = _wire_s(link, ici_bw, dcn_bw, wan_bw)
    dense_wire_s = _wire_s(dense_link, ici_bw, dcn_bw, wan_bw)
    step_s = base_step_s + wire_s * (1.0 - overlap)
    d_step_s = dense_step_s + dense_wire_s
    extra: Dict[str, Any] = {}
    adapt = getattr(grace, "adapt", None)
    if adapt is not None:
        # An adaptive candidate is priced at its steady state, the top
        # rung (the base codec); every rung's price rides along.
        extra = {"steady_state_rung": len(adapt.ladder),
                 "rung_prices": adapt_rung_prices(
                     grace, structs, spec, base_step_s=base_step_s,
                     constants=constants)}
    return {
        **extra,
        "payload_bytes": int(wire_b),
        "wire_ratio": round(wire_b / max(1, dense_b), 6),
        "negotiation_bytes": int(neg_b),
        "ici_bytes": int(link.ici),
        "dcn_bytes": int(link.dcn),
        "wan_bytes": int(link.wan),
        "wire_ms": round(wire_s * 1e3, 9),
        "wire_pipeline_overlap": round(overlap, 6),
        "dense_ici_bytes": int(dense_link.ici),
        "dense_dcn_bytes": int(dense_link.dcn),
        "dense_wan_bytes": int(dense_link.wan),
        "dense_wire_ms": round(dense_wire_s * 1e3, 9),
        "projected_step_ms": round(step_s * 1e3, 9),
        "dense_projected_step_ms": round(d_step_s * 1e3, 9),
        "predicted_speedup_vs_dense": (round(d_step_s / step_s, 4)
                                       if step_s > 0 else None),
    }


def adapt_rung_prices(grace, model_structs, spec: TuneTopology, *,
                      base_step_s: float = 0.0,
                      constants: Optional[Tuple[float, float, float]] = None
                      ) -> list:
    """Static prices of an adaptive candidate's whole ladder: rung 0 the
    dense escape's all-reduce (at the escape codec's payload width), rung
    ``r >= 1`` the ladder's codec through the candidate's communicator,
    each through the same per-link model."""
    from grace_tpu_torch.comm import Allreduce

    ici_bw, dcn_bw, wan_bw, _ = projection_constants(constants)
    structs = _structs(model_structs)
    n = n_elements(structs)
    topo = spec.core_topology()
    esc = getattr(grace, "escape", None)
    esc_b = (_payload_bytes(esc, structs) if esc is not None
             else dense_bytes(structs))
    link0 = Allreduce(group=grace.communicator.group).recv_link_bytes(
        esc_b, n, spec.world, topology=topo)
    out = [{"rung": 0,
            "codec": type(esc).__name__ if esc is not None else "dense",
            "payload_bytes": int(esc_b),
            "ici_bytes": int(link0.ici), "dcn_bytes": int(link0.dcn),
            "wan_bytes": int(link0.wan),
            "projected_step_ms": round(
                (base_step_s + _wire_s(link0, ici_bw, dcn_bw, wan_bw))
                * 1e3, 9)}]
    for ri, comp in enumerate(grace.adapt.ladder, start=1):
        wire_b = _payload_bytes(comp, structs)
        vote = bool(getattr(comp, "vote_aggregate", False))
        link = grace.communicator.recv_link_bytes(
            wire_b, n, spec.world, topology=topo, vote=vote)
        out.append({"rung": ri, "codec": type(comp).__name__,
                    "payload_bytes": int(wire_b),
                    "negotiation_bytes": int(
                        comp.negotiation_nbytes(spec.world)),
                    "ici_bytes": int(link.ici), "dcn_bytes": int(link.dcn),
                    "wan_bytes": int(link.wan),
                    "projected_step_ms": round(
                        (base_step_s + _wire_s(link, ici_bw, dcn_bw,
                                               wan_bw)) * 1e3, 9)})
    return out
