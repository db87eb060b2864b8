"""Named trace stages; counterpart of the JAX package's
``telemetry/scopes.py``.

The stage names are the JAX package's, so one vocabulary reads both
packages' traces, plus the train step's own finer stages
(:data:`PORT_STAGES`: the step's root, its forward, backward, buffer and
loss averages, and the optimizer's update), which nest inside the JAX
package's and which :func:`match_stage` resolves the same way.
:func:`trace_stage` is the port's one instrument, with three recorders
behind it:

* **the profiler**: a ``torch.profiler.record_function`` span of the
  stage's name, which the profiler's trace and ``key_averages()`` show as
  a host range with the kernels launched inside it (the JAX package names
  XLA op metadata instead);
* **the span log** (:mod:`grace_tpu_torch.telemetry.spans`): while it is
  armed, a record of each span's host and device start and end on one
  clock, without the profiler;
* **the auditor** (:mod:`grace_tpu_torch.analysis`): the stage of every
  op it records.

While the auditor records or the collective counters
(:mod:`grace_tpu_torch.telemetry.counters`) are armed, the names of the
open spans are on one stage stack, :data:`STAGE_STACK`, innermost last:
the auditor names each op's stage by its top, the counters each call's.
With none of them on, a span costs the profiler's check and one flag
check and allocates nothing, so the per-leaf paths pay no host time for
it.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional

__all__ = ["trace_stage", "match_stage", "ALL_STAGES",
           "STAGE_COMPENSATE", "STAGE_COMPRESS",
           "STAGE_EXCHANGE", "STAGE_DECOMPRESS", "STAGE_MEMORY_UPDATE",
           "STAGE_FWD_BWD", "STAGE_OPTIMIZER", "STAGE_APPLY",
           "STAGE_TELEMETRY", "STAGE_DENSE_ESCAPE", "STAGE_CONSENSUS",
           "STAGE_RING_HOP", "STAGE_WATCH", "STAGE_BUCKET", "STAGE_ADAPT",
           "STAGE_PIPELINE", "STAGE_STEP", "STAGE_FORWARD",
           "STAGE_BACKWARD", "STAGE_BUFFER_MEAN", "STAGE_LOSS_MEAN",
           "PORT_STAGES"]

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
# The train step's own stages: the root of one step, and the parts of it
# that the JAX package's single jitted step has no host boundary for.
STAGE_STEP = "grace/step"
STAGE_FORWARD = "grace/forward"           # inside grace/forward_backward
STAGE_BACKWARD = "grace/backward"         # inside grace/forward_backward
STAGE_BUFFER_MEAN = "grace/buffer_mean"   # the model's buffers averaged
STAGE_LOSS_MEAN = "grace/loss_mean"       # the loss averaged
PORT_STAGES = (STAGE_STEP, STAGE_FORWARD, STAGE_BACKWARD, STAGE_BUFFER_MEAN,
               STAGE_LOSS_MEAN)

# Longest first, so that a nested path attributes to the longest stage at
# the rightmost position (match_stage): grace/forward_backward is not
# grace/forward.
ALL_STAGES = tuple(sorted(
    (STAGE_COMPENSATE, STAGE_COMPRESS, STAGE_EXCHANGE, STAGE_DECOMPRESS,
     STAGE_MEMORY_UPDATE, STAGE_FWD_BWD, STAGE_OPTIMIZER, STAGE_APPLY,
     STAGE_TELEMETRY, STAGE_DENSE_ESCAPE, STAGE_CONSENSUS, STAGE_RING_HOP,
     STAGE_WATCH, STAGE_BUCKET, STAGE_ADAPT, STAGE_PIPELINE) + PORT_STAGES,
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


# The names of the open spans, innermost last, while the auditor records a
# trace (analysis.trace sets and clears it) or the collective counters are
# armed (counters.arm); else None.
STAGE_STACK: Optional[List[str]] = None
# The armed span log (spans.arm sets it, spans.disarm clears it), else None.
SPAN_LOG = None


@contextlib.contextmanager
def trace_stage(name: str) -> Iterator[None]:
    """A span named ``name``: a ``record_function`` range while a profiler
    records, a record of the armed span log, and ``name`` on
    :data:`STAGE_STACK` while it is live. Nothing otherwise."""
    import torch                  # here: the read side imports no torch

    stack = STAGE_STACK
    if stack is not None:
        stack.append(name)
    log = SPAN_LOG
    span = -1 if log is None else log.open(name)
    try:
        if not torch.autograd._profiler_enabled():
            yield
            return
        with torch.profiler.record_function(name):
            yield
    finally:
        if log is not None:
            log.close(span, name)
        if stack is not None:
            stack.pop()
