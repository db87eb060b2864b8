"""Named trace stages; counterpart of the JAX package's
``telemetry/scopes.py``.

The stage names are the JAX package's, so one vocabulary reads both
packages' traces. :func:`trace_stage` opens a
``torch.profiler.record_function`` span of the stage's name, which the
profiler's trace and ``key_averages()`` show as a host range with the
kernels launched inside it; the JAX package names XLA op metadata instead.
Outside a profiler session it does nothing, so the per-leaf paths pay no
host time for it. While the static auditor (:mod:`grace_tpu_torch.analysis`)
records a trace, it also pushes its name onto the recorder's stage stack
(:data:`STAGE_STACK`), which names the stage of every recorded op.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional

import torch

__all__ = ["trace_stage", "match_stage", "ALL_STAGES",
           "STAGE_COMPENSATE", "STAGE_COMPRESS",
           "STAGE_EXCHANGE", "STAGE_DECOMPRESS", "STAGE_MEMORY_UPDATE",
           "STAGE_FWD_BWD", "STAGE_OPTIMIZER", "STAGE_APPLY",
           "STAGE_TELEMETRY", "STAGE_DENSE_ESCAPE", "STAGE_CONSENSUS",
           "STAGE_RING_HOP", "STAGE_WATCH", "STAGE_BUCKET", "STAGE_ADAPT",
           "STAGE_PIPELINE"]

STAGE_COMPENSATE = "grace/compensate"
STAGE_COMPRESS = "grace/compress"
STAGE_EXCHANGE = "grace/exchange"
STAGE_DECOMPRESS = "grace/decompress"
STAGE_MEMORY_UPDATE = "grace/memory_update"
STAGE_FWD_BWD = "grace/forward_backward"
STAGE_OPTIMIZER = "grace/optimizer"
STAGE_APPLY = "grace/apply_updates"
STAGE_TELEMETRY = "grace/telemetry"
STAGE_DENSE_ESCAPE = "grace/dense_escape"
STAGE_CONSENSUS = "grace/consensus"
STAGE_RING_HOP = "grace/ring_hop"
STAGE_WATCH = "grace/watch"
STAGE_BUCKET = "grace/bucket"
STAGE_ADAPT = "grace/adapt"
STAGE_PIPELINE = "grace/pipeline"

# Longest first, so that a nested path attributes to the longest stage at
# the rightmost position (match_stage).
ALL_STAGES = tuple(sorted(
    (STAGE_COMPENSATE, STAGE_COMPRESS, STAGE_EXCHANGE, STAGE_DECOMPRESS,
     STAGE_MEMORY_UPDATE, STAGE_FWD_BWD, STAGE_OPTIMIZER, STAGE_APPLY,
     STAGE_TELEMETRY, STAGE_DENSE_ESCAPE, STAGE_CONSENSUS, STAGE_RING_HOP,
     STAGE_WATCH, STAGE_BUCKET, STAGE_ADAPT, STAGE_PIPELINE),
    key=len, reverse=True))


def match_stage(path: str) -> str:
    """The canonical stage a scope path or op name belongs to: the
    rightmost stage of :data:`ALL_STAGES` found in ``path`` (the innermost
    scope does the work), the longest one at a tie; else the raw
    ``grace/<x>`` prefix of an ad-hoc sub-scope; else ``""``."""
    best, best_pos = "", -1
    for stage in ALL_STAGES:
        pos = path.rfind(stage)
        if pos > best_pos:
            best, best_pos = stage, pos
    if best:
        return best
    segs = [seg for seg in path.split("/") if seg]
    if "grace" not in segs:
        return ""
    i = segs.index("grace")
    return "/".join(segs[i:i + 2])


# The auditor's stage stack while it records a trace (analysis.trace sets
# and clears it), else None.
STAGE_STACK: Optional[List[str]] = None


@contextlib.contextmanager
def trace_stage(name: str) -> Iterator[None]:
    """A ``record_function`` span named ``name`` while a profiler records;
    nothing otherwise. Under the auditor's recorder, ``name`` is on its
    stage stack for the span's length."""
    stack = STAGE_STACK
    if stack is not None:
        stack.append(name)
    try:
        if not torch.autograd._profiler_enabled():
            yield
            return
        with torch.profiler.record_function(name):
            yield
    finally:
        if stack is not None:
            stack.pop()
