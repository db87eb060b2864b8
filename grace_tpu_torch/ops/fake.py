"""The kernel wrappers' fake branch, for the static auditor.

:mod:`grace_tpu_torch.analysis` traces a step with ``FakeTensor`` inputs
(shapes, dtypes and devices, no data). A wrapper given fake tensors returns
fake outputs of its kernel's shapes and dtypes through :func:`launch` and
records one ``kernel`` node under the kernel's name with the auditor's
recorder, when one runs. It never builds or loads a library, reads a
pointer or counts a launch: a real tensor takes the wrapper's real path.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["is_fake", "launch", "RECORDER"]

# The recorder of the trace in progress (analysis.trace sets and clears
# it), else None.
RECORDER = None


def is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


def launch(name: str, reads: Sequence, make: Callable[[], Tuple]):
    """The fake launch of kernel ``name``: ``make()`` builds ``(result,
    written)`` (``written``: the tensors the kernel writes, in place or
    fresh) and the recorder, if any, notes one node reading ``reads`` and
    writing ``written``. Returns ``result``."""
    rec = RECORDER
    if rec is None:
        return make()[0]
    with rec.quiet():
        result, written = make()
    rec.kernel(name, [t for t in reads if isinstance(t, torch.Tensor)],
               [t for t in written if isinstance(t, torch.Tensor)])
    return result
