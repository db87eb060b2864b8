"""graft-watch: the cross-rank health summary; counterpart of the JAX
package's ``telemetry/aggregate.py``.

The telemetry ring records per-rank scalars and the reader joins them only
at a flush. The question that matters at scale, whether one rank drifts
away from the fleet, needs the cross-rank view inside the step, for the
cost of one tiny collective a window:

* every rank stacks its local health scalars (the pre-exchange gradient
  norm, the relative compression error, the error-feedback residual norm:
  :data:`WATCH_METRICS`) into one ``(3,)`` float32 vector;
* one ``all_gather_into_tensor`` moves the vectors over the group
  (``(W-1)·12`` bytes received a rank, :func:`watch_gather_bytes`);
* from the gathered ``(W, 3)`` matrix every rank derives the replicated
  mean/min/max of each metric, its own **skew** (its value less the
  mean), and the replicated ``skew_max``/``skew_rank`` pair (the largest
  relative compression-error deviation and the first rank holding it);
* the row lands in a bounded per-rank ring (:class:`WatchState`) keyed by
  the GRACE step counter, which the reader drains with the telemetry ring.

The window predicate ``count % window == 0`` is computed on the host from
the GRACE step counter, the same number on every rank, so every rank
gathers at the same steps; steps off the window make no collective. The
gather's bytes are folded into the telemetry row's ``wire_bytes`` and its
per-link split, and surfaced as ``watch_bytes``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist

__all__ = ["WATCH_FIELDS", "WATCH_FIELD_INDEX", "WATCH_METRICS",
           "WatchConfig", "WatchState", "normalize_watch", "watch_init",
           "watch_gather_bytes", "watch_record"]

# The local health scalars gathered across ranks, in gather-column order.
WATCH_METRICS = ("grad_norm", "compression_error", "residual_norm")

# Ring columns of one watch row and their host-side reading, the JAX
# package's: "first" is the same on every rank (derived from the gathered
# matrix); "gather" is per rank, and the reader assembles the W values
# into a vector.
WATCH_FIELDS = (
    ("grad_norm_mean", "first"),
    ("grad_norm_min", "first"),
    ("grad_norm_max", "first"),
    ("compression_error_mean", "first"),
    ("compression_error_min", "first"),
    ("compression_error_max", "first"),
    ("residual_norm_mean", "first"),
    ("residual_norm_min", "first"),
    ("residual_norm_max", "first"),
    ("grad_norm_skew", "gather"),          # own value − replicated mean
    ("compression_error_skew", "gather"),
    ("residual_norm_skew", "gather"),
    ("skew_max", "first"),    # max relative compression-error deviation
    ("skew_rank", "first"),   # the first rank holding skew_max
    ("watch_bytes", "first"),  # the gather's received bytes this row
)

WATCH_FIELD_INDEX = {name: i for i, (name, _) in enumerate(WATCH_FIELDS)}


@dataclasses.dataclass(frozen=True)
class WatchConfig:
    """``window``: steps between cross-rank summaries. ``capacity`` bounds
    the summary ring; size it to at least ``flush_interval / window`` rows,
    or the reader sees wraparound (counted, as for the telemetry ring)."""

    window: int = 10
    capacity: int = 16

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"watch window must be >= 1; got {self.window}")
        if self.capacity < 1:
            raise ValueError(f"watch capacity must be >= 1; "
                             f"got {self.capacity}")


def normalize_watch(watch) -> Optional[WatchConfig]:
    """The watch knob's spellings: None/False (off), True (defaults), an int
    (the window), a dict (config kwargs) or a WatchConfig."""
    if watch is None or watch is False:
        return None
    if watch is True:
        return WatchConfig()
    if isinstance(watch, WatchConfig):
        return watch
    if isinstance(watch, int):
        return WatchConfig(window=watch)
    if isinstance(watch, dict):
        return WatchConfig(**watch)
    raise TypeError(f"watch must be None/bool/int/dict/WatchConfig; "
                    f"got {type(watch).__name__}")


class WatchState(NamedTuple):
    """The summary ring, per-rank data like the telemetry ring (the skew
    columns differ by rank). Rows are keyed by the GRACE step counter; a
    slot holding step -1 was never written."""

    rings: torch.Tensor   # (capacity, len(WATCH_FIELDS)) float32 rows
    steps: torch.Tensor   # (capacity,) int32 step of each row; -1 = none


def watch_init(config: WatchConfig, device=None) -> WatchState:
    return WatchState(
        rings=torch.zeros((config.capacity, len(WATCH_FIELDS)),
                          dtype=torch.float32, device=device),
        steps=torch.full((config.capacity,), -1, dtype=torch.int32,
                         device=device))


def watch_gather_bytes(world: int) -> int:
    """Bytes one rank receives in one watch gather: every other rank's
    ``(len(WATCH_METRICS),)`` float32 vector."""
    return max(0, world - 1) * len(WATCH_METRICS) * 4


def _world(group) -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def watch_record(watch: WatchState, count: int,
                 values: Mapping[str, object], group=None) -> WatchState:
    """A new ring with one cross-rank summary row at slot ``count %
    capacity``. ``values`` maps each :data:`WATCH_METRICS` name to this
    rank's scalar (a 0-d tensor on the ring's device or a Python number).
    The caller decides that the row is due (a window boundary); every rank
    of ``group`` must call this at the same steps, for the gather. Nothing
    here reads a value back to the host, and the old ring is left as it
    was (the guard's rollback selects it on a bad step)."""
    # Lazy: comm and core import this package's scopes.
    from grace_tpu_torch.comm import _all_gather_into
    from grace_tpu_torch.core import mean_scale

    missing = [m for m in WATCH_METRICS if m not in values]
    if missing:
        raise KeyError(f"watch_record missing metrics {missing}")
    device = watch.rings.device
    local = torch.empty(len(WATCH_METRICS), dtype=torch.float32,
                        device=device)
    for i, m in enumerate(WATCH_METRICS):
        v = values[m]
        if isinstance(v, torch.Tensor):
            local[i].copy_(v.reshape(()))   # a device copy, no host value
        else:
            local[i].fill_(float(v))
    world = _world(group)
    if world > 1:
        flat = torch.empty(world * local.numel(), dtype=torch.float32,
                           device=device)
        _all_gather_into(flat, local, group=group)
        gathered = flat.view(world, local.numel())          # (W, 3)
    else:
        gathered = local[None]
    # jnp.mean over the world axis: the sum times 1/W, as jitted XLA has it.
    mean = gathered.sum(0) * mean_scale(world)
    mn = gathered.amin(0)
    mx = gathered.amax(0)
    skew = local - mean
    err = WATCH_METRICS.index("compression_error")
    rel = (gathered[:, err] - mean[err]).abs() \
        / torch.clamp(mean[err].abs(), min=1e-12)
    row = torch.cat([
        torch.stack([mean, mn, mx], dim=1).reshape(-1),      # per metric
        skew,
        torch.stack([rel.max(), torch.argmax(rel).to(torch.float32),
                     rel.new_full((), float(watch_gather_bytes(world)))]),
    ])
    idx = count % watch.steps.shape[0]
    rings = watch.rings.clone()
    rings[idx].copy_(row)
    steps = watch.steps.clone()
    steps[idx].fill_(int(count))   # a fill: item assignment would sync
    return WatchState(rings=rings, steps=steps)
