"""Tensor primitives and the port's hand-written CUDA kernels.

``chunk_topk`` holds the chunk Top-K kernels' wrappers and plain versions;
``_build`` compiles ``grace_tpu_torch/csrc`` with nvcc at first use. No
module here touches CUDA, nvcc or triton when it is imported.
"""
