"""grace_tpu_torch: the PyTorch and CUDA port of the JAX package grace_tpu

The Compressor / Memory / Communicator pipeline over ``torch.distributed``
process groups, with the chunk Top-K kernels hand-written in CUDA for
Hopper (``grace_tpu_torch/csrc``). The JAX package ``grace_tpu`` stays the
reference: the port keeps its parameter layouts, its params-dict schema
and its numerics, and the tests hold the two against each other.

Entry points run on CUDA unless the caller passes ``device="cpu"``. The
names below import on first use, so the read-side command lines
(``python -m grace_tpu_torch.telemetry``, ``.telemetry.watch``,
``.profiling``, ``.evidence``) start without torch.
"""

from grace_tpu_torch._lazy import lazy_exports

__all__ = ["Grace", "GraceState", "GraceTransform", "grace_from_params",
           "grace_transform"]

__getattr__, __dir__ = lazy_exports(__name__, {
    ".helper": ("Grace", "grace_from_params"),
    ".transform": ("GraceState", "GraceTransform", "grace_transform")})
