"""Tensor primitives and the port's hand-written CUDA kernels.

``chunk_topk`` holds the chunk Top-K kernels' wrappers and plain versions,
``quant`` the QSGD quantize, quantize-and-pack and sign-pack kernels',
``wire`` the decode→accumulate and packed integer accumulate kernels';
``packing`` holds the sub-byte packers and ``sparse`` the dense builds of
sparse payloads. ``_build`` compiles ``grace_tpu_torch/csrc`` with nvcc at
first use. No module here touches CUDA, nvcc or triton when it is
imported.
"""

from grace_tpu_torch.ops import chunk_topk, quant, wire


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch counter to 0."""
    for mod in (chunk_topk, quant, wire):
        mod.reset_launch_counts()


def launch_counts() -> dict:
    """Every kernel's launches, by kernel name (a kernel's one-leaf and
    grouped wrappers add up)."""
    return {**chunk_topk.launch_counts(), **quant.launch_counts(),
            **{f.__name__: f.launches for f in (
                wire.decode_accumulate, wire.packed_int_accumulate)}}
