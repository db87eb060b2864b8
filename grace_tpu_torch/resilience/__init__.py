"""Training resilience: the non-finite step guard and the dense escape;
counterpart of the JAX package's ``resilience`` (its ``guard`` and
``guarded_chain``; consensus, chaos, adapt, elastic and retune are not
ported yet).

* :func:`guard_transform` wraps the GRACE transform and the torch
  optimizer: a step whose update or new state is non-finite (or whose
  update norm exceeds ``max_norm``) is skipped, and the parameters, the
  optimizer state and every GraceState tensor roll back together.
* The dense escape: ``grace_transform(escape=...)`` with the guard's
  ``fallback_after``/``fallback_steps``: after K consecutive bad steps the
  exchange is a dense (none/fp16/bf16) all-reduce for M steps, then
  compression re-arms.
"""

from __future__ import annotations

from typing import Optional

from grace_tpu_torch.resilience.guard import (GUARD_ROLLBACK_EXCLUDED,
                                              GUARD_SCAN_EXCLUDED_TYPES,
                                              GuardState, GuardTransform,
                                              guard_transform)

__all__ = ["GUARD_ROLLBACK_EXCLUDED", "GUARD_SCAN_EXCLUDED_TYPES",
           "GuardState", "GuardTransform", "guard_transform",
           "guarded_chain"]


def guarded_chain(grace, *, seed: int = 0, max_norm: Optional[float] = None,
                  check_state: bool = True,
                  fallback_after: Optional[int] = None,
                  fallback_steps: Optional[int] = None) -> GuardTransform:
    """``guard_transform(grace.transform(seed))`` with the guard's verdict
    OR-reduced over the grace communicator's process group.

    The chain is the transform followed by the train state's torch
    optimizer, which the guard steps and rolls back
    (``train.make_train_step``/``make_stateful_train_step`` take the
    result in place of a GraceTransform). ``grace`` is a
    :class:`~grace_tpu_torch.helper.Grace`; its ``escape`` (e.g.
    ``"escape": "fp16"`` in ``grace_from_params``) is the dense codec of
    the window that ``fallback_after``/``fallback_steps`` control."""
    return guard_transform(grace.transform(seed=seed), max_norm=max_norm,
                           check_state=check_state,
                           fallback_after=fallback_after,
                           fallback_steps=fallback_steps,
                           group=grace.communicator.group)
