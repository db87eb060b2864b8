"""grace_tpu_torch: the PyTorch and CUDA port of the JAX package grace_tpu

The Compressor / Memory / Communicator pipeline over ``torch.distributed``
process groups, with the chunk Top-K kernels hand-written in CUDA for
Hopper (``grace_tpu_torch/csrc``). The JAX package ``grace_tpu`` stays the
reference: the port keeps its parameter layouts, its params-dict schema
and its numerics, and the tests hold the two against each other.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from grace_tpu_torch.helper import Grace, grace_from_params
from grace_tpu_torch.transform import GraceState, GraceTransform, grace_transform

__all__ = ["Grace", "GraceState", "GraceTransform", "grace_from_params",
           "grace_transform"]
