"""Collective counters: the calls and bytes this rank puts into
collectives, by op and by the innermost stage open at the call.

Every collective of the step's path calls :func:`count` just before it
issues the call: the communicators' gathers, all-to-alls, all-reduces and
ring hops, the masked broadcast, the train step's buffer and loss
averages, the codecs' and memories' own reductions, the guard's verdict,
and ``parallel``'s all-reduces and broadcasts. The bytes are those of the
tensors this rank hands in: an all-reduce's or an all-gather's input, an
all-to-all's send buffer, a ring hop's sends, a broadcast's tensor at its
source (0 elsewhere, and for an object broadcast). A batch of
point-to-point calls counts once.

They count between :func:`arm` (which starts them from zero) and
:func:`disarm`; arming the span log arms them too
(:func:`grace_tpu_torch.telemetry.spans.arm`). While they are armed the
stage stack (:data:`~grace_tpu_torch.telemetry.scopes.STAGE_STACK`) is
live, so each call is keyed by the stage around it. Read them::

    from grace_tpu_torch.telemetry import counters
    counters.arm()
    for _ in range(20):
        state, loss = step(state, batch)
    counters.disarm()
    got = counters.collective_counts()
    per_step = sum(got["calls"].values()) / 20

Disarmed, a call costs one flag check and allocates nothing; armed, a
dictionary update (about a microsecond).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from grace_tpu_torch.telemetry import scopes

__all__ = ["arm", "disarm", "count", "collective_counts"]

_ON = False
_CALLS: Dict[Tuple[str, str], int] = {}
_BYTES: Dict[Tuple[str, str], int] = {}
# The stage stack arm found (the auditor's, or None), for disarm to put back.
_outer_stack: Optional[list] = None


def arm() -> None:
    """Count from zero until :func:`disarm`, with the stage stack live."""
    global _ON, _outer_stack
    if _ON:
        raise RuntimeError("the collective counters are already armed")
    _CALLS.clear()
    _BYTES.clear()
    _outer_stack = scopes.STAGE_STACK
    if _outer_stack is None:
        scopes.STAGE_STACK = []
    _ON = True


def disarm() -> None:
    """Stop counting; the counts stay readable until the next :func:`arm`."""
    global _ON
    if _ON:
        _ON = False
        scopes.STAGE_STACK = _outer_stack


def count(op: str, *tensors) -> None:
    """One call of collective ``op`` that puts ``tensors`` in, keyed by
    the innermost open stage (``""`` outside every span)."""
    if not _ON:
        return
    stack = scopes.STAGE_STACK
    key = (op, stack[-1] if stack else "")
    _CALLS[key] = _CALLS.get(key, 0) + 1
    _BYTES[key] = _BYTES.get(key, 0) + sum(
        t.numel() * t.element_size() for t in tensors)


def collective_counts() -> dict:
    """``{"calls": {(op, stage): calls}, "bytes": {(op, stage): bytes}}``
    since the last :func:`arm`."""
    return {"calls": dict(_CALLS), "bytes": dict(_BYTES)}
