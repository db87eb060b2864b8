"""The telemetry ring: a bounded device buffer of per-step scalars;
counterpart of the JAX package's ``telemetry/state.py``.

``grace_transform(telemetry=...)`` threads a :class:`TelemetryState`
through ``GraceState.telem`` and writes one row of :data:`FIELDS` at the end
of every update, at slot ``count % capacity``: every value is computed and
written on the device, so recording never waits for the card. A
:class:`~grace_tpu_torch.telemetry.reader.TelemetryReader` drains the ring
in one device-to-host transfer a window.

The ring is per-rank data, like ``mem`` and ``comp``: each rank records its
own scalars and the reader aggregates them at flush time by each field's
``agg``. Rows are keyed by the GRACE step counter; a slot holding step -1
was never written. A step that the guard skips rolls the ring back with the
rest of the state, so it leaves no row. Everything is float32: byte counts
above 2**24 round, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import torch

__all__ = ["FIELDS", "FIELD_INDEX", "TelemetryConfig", "TelemetryState",
           "telemetry_init", "telemetry_record"]

# (name, host-side cross-rank aggregation) in ring-column order, the JAX
# package's. "first": identical on every rank; "mean"/"max": per-rank.
FIELDS = (
    ("grad_norm", "mean"),          # ‖local grad‖ over all leaves
    ("update_norm", "mean"),        # ‖aggregated update‖
    ("residual_norm", "mean"),      # ‖error-feedback memory‖ of this rank
    ("residual_max", "max"),        # max |residual|
    ("compression_error", "mean"),  # ‖g − decompress(compress(g))‖ / ‖g‖
    ("wire_bytes", "first"),        # effective bytes received this step
    ("dense_bytes", "first"),       # raw dense bytes of the gradients
    ("fallback", "max"),            # 1.0 while the dense escape runs
    ("audit_bytes", "first"),       # consensus audit cost (0: not ported)
    ("wire_bytes_ici", "first"),    # wire_bytes split by link class
    ("wire_bytes_dcn", "first"),
    ("wire_bytes_wan", "first"),
    ("watch_bytes", "first"),       # health-gather cost (0: not ported)
    ("negotiation_bytes", "first"), # shared-scale negotiation cost
    ("adapt_rung", "first"),        # effective adaptive rung (-1: off)
    ("adapt_bytes", "first"),       # the adaptive signal's cost
)

FIELD_INDEX = {name: i for i, (name, _) in enumerate(FIELDS)}


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """``capacity`` bounds the ring (at least the reader's flush interval,
    or a window's oldest rows are overwritten and counted as dropped).
    ``compression_error`` gates the one metric that costs a codec
    round-trip a step."""

    capacity: int = 128
    compression_error: bool = True

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"telemetry capacity must be >= 1; "
                             f"got {self.capacity}")


class TelemetryState(NamedTuple):
    rings: torch.Tensor   # (capacity, len(FIELDS)) float32 metric rows
    steps: torch.Tensor   # (capacity,) int32 step of each row; -1 = none


def telemetry_init(config: TelemetryConfig, device=None) -> TelemetryState:
    return TelemetryState(
        rings=torch.zeros((config.capacity, len(FIELDS)),
                          dtype=torch.float32, device=device),
        steps=torch.full((config.capacity,), -1, dtype=torch.int32,
                         device=device))


def telemetry_record(telem: TelemetryState, count: int,
                     values: Mapping[str, object]) -> TelemetryState:
    """A new ring with one row of scalars at slot ``count % capacity``.

    ``values`` gives every :data:`FIELDS` name, as a 0-d tensor on the
    ring's device or a Python number; each becomes float32. The old ring is
    left as it was (the guard's rollback selects it on a bad step), and
    nothing here copies from the host or waits for the device."""
    missing = [name for name, _ in FIELDS if name not in values]
    if missing:
        raise KeyError(f"telemetry_record missing fields {missing}")
    idx = count % telem.steps.shape[0]
    rings = telem.rings.clone()
    row = rings[idx]
    for i, (name, _) in enumerate(FIELDS):
        v = values[name]
        if isinstance(v, torch.Tensor):
            row[i].copy_(v.reshape(()))     # a device copy, no host value
        else:
            row[i].fill_(float(v))
    steps = telem.steps.clone()
    steps[idx].fill_(int(count))   # a fill: item assignment would sync
    return TelemetryState(rings=rings, steps=steps)
