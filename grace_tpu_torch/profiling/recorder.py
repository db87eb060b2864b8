"""GraceState footprint accounting; counterpart of the footprint functions
of the JAX package's ``profiling/recorder.py``.

The JAX package holds the whole mesh's state in one global array, whose
per-rank fields (``mem``, ``comp``, the rings) carry a leading world axis.
The port holds one rank's state a process, so the functions take ``world``
and scale the per-rank bytes by it: the numbers are JAX's integers for the
same configuration and world. The replicated bookkeeping (``count``, the
key, ``fallback``, ``audit``, ``adapt``) counts once, at JAX's widths.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

__all__ = ["grace_state_footprint", "expected_state_footprint",
           "check_state_footprint"]


def _nbytes(tree) -> int:
    from grace_tpu_torch.transform import _state_tensors
    return sum(t.numel() * t.element_size() for t in _state_tensors(tree))


def grace_state_footprint(tree, world: int = 1) -> Dict[str, int]:
    """Bytes held by every GraceState in ``tree`` (a GraceState, a guard's
    state, a train state, or dicts, lists and tuples of them), by
    component: ``mem`` (residuals), ``comp`` (compressor state, e.g.
    PowerSGD's Q), ``telem`` (the telemetry and watch rings), each this
    rank's bytes times ``world``, and ``bookkeeping`` (the replicated
    scalars)."""
    from grace_tpu_torch.resilience.consensus import (_ADAPT_HOST_NBYTES,
                                                      _AUDIT_NBYTES,
                                                      _GRACE_SCALAR_NBYTES,
                                                      _nodes)
    from grace_tpu_torch.transform import GraceState

    graces = _nodes(tree, GraceState)
    mem = sum(_nbytes(g.mem) for g in graces) * world
    comp = sum(_nbytes(g.comp) for g in graces) * world
    telem = sum(_nbytes([g.telem, g.watch]) for g in graces) * world
    # At JAX's widths (the consensus view's); the controller's two float32
    # statistics are 4 bytes each.
    book = sum(_GRACE_SCALAR_NBYTES
               + (_AUDIT_NBYTES if g.audit is not None else 0)
               + (_ADAPT_HOST_NBYTES + 8 if g.adapt is not None else 0)
               for g in graces)
    return {"grace_states": len(graces),
            "mem_bytes": mem, "comp_bytes": comp, "telem_bytes": telem,
            "bookkeeping_bytes": book,
            "total_bytes": mem + comp + telem + book}


def expected_state_footprint(grace_or_tx, params, world: int = 1
                             ) -> Dict[str, int]:
    """The configuration's expected footprint for ``params`` (a mapping of
    names to tensors) at ``world`` ranks: the state ``init`` builds, on
    the meta device (shapes and dtypes, no memory, no collective), counted
    by :func:`grace_state_footprint`. ``grace_or_tx`` is a ``Grace``
    bundle, a transform or a guarded chain."""
    if hasattr(grace_or_tx, "transform"):
        # An explicit layout: detecting one is a collective of the Grace's
        # group, and the footprint does not depend on it.
        from grace_tpu_torch.core import Topology
        tx = dataclasses.replace(
            grace_or_tx, topology=grace_or_tx.topology or Topology()
        ).transform(seed=0)
    else:
        tx = grace_or_tx
    meta = {k: torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")
            for k, v in params.items()}
    return grace_state_footprint(tx.init(meta), world)


def check_state_footprint(state, grace_or_tx, params, world: int = 1
                          ) -> Dict[str, Any]:
    """Live GraceState bytes against the expected model at ``world``:
    ``matches`` compares the three per-codec components exactly (a
    mismatch means the state was built under another codec, fusion,
    telemetry configuration or world)."""
    live = grace_state_footprint(state, world)
    model = expected_state_footprint(grace_or_tx, params, world)
    matches = all(live[k] == model[k]
                  for k in ("mem_bytes", "comp_bytes", "telem_bytes"))
    return {"live": live, "model": model, "matches": matches}
