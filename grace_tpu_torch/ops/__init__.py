"""Tensor primitives, the port's hand-written CUDA kernels, and the switch
that selects them.

``chunk_topk`` holds the chunk Top-K kernels' wrappers and plain versions,
``quant`` the QSGD quantize, quantize-and-pack and sign-pack kernels',
``wire`` the decode→accumulate and packed integer accumulate kernels';
``packing`` holds the sub-byte packers and ``sparse`` the dense builds of
sparse payloads. ``_build`` compiles ``grace_tpu_torch/csrc`` with nvcc at
first use. No module here touches CUDA, nvcc or triton when it is
imported.

:func:`pallas_mode` is the one rule by which every codec picks a kernel
path or its staged path, counterpart of ``pallas_mode`` in the JAX
package's ``ops/__init__.py`` (the names are kept so that a reader finds
the counterpart). The environment turns kernel families off:
``GRACE_DISABLE_PALLAS`` every family, ``GRACE_DISABLE_PALLAS_<FAMILY>``
one of ``FAMILIES`` (``quant``: the encode kernels of ``ops/quant.py``;
``wire``: the decode and accumulate kernels of ``ops/wire.py``; ``topk``:
the chunk Top-K kernels). A value of '', 0, false, no or off (any case)
leaves the family on.
"""

import os
import warnings

from grace_tpu_torch.ops import chunk_topk, quant, wire

FAMILIES = ("quant", "wire", "topk")


def _env_true(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "no", "off")


def pallas_disabled(explicit: bool = False, kernel: str = "") -> bool:
    """True when the environment turns kernel family ``kernel`` off:
    ``GRACE_DISABLE_PALLAS`` (every family) or
    ``GRACE_DISABLE_PALLAS_<KERNEL>`` (that family alone) set to a true
    value. Warns (``RuntimeWarning``) when it overrides an explicit
    ``use_pallas=True``: a forgotten export would otherwise turn a kernel
    check into a comparison of the staged path with itself."""
    var = None
    if _env_true("GRACE_DISABLE_PALLAS"):
        var = "GRACE_DISABLE_PALLAS"
    elif kernel and _env_true("GRACE_DISABLE_PALLAS_" + kernel.upper()):
        var = "GRACE_DISABLE_PALLAS_" + kernel.upper()
    if var is None:
        return False
    if explicit:
        warnings.warn(f"{var} is set: overriding explicit use_pallas=True; "
                      "the kernels will NOT run", RuntimeWarning,
                      stacklevel=3)
    return True


def pallas_mode(use_pallas, kernel: str = "quant") -> bool:
    """True when a codec with knob ``use_pallas`` (True, False or 'auto')
    takes the kernel path of family ``kernel``: not switched off by the
    environment and ``use_pallas`` not False. The port has no interpret
    mode: on a CUDA tensor the kernel path launches the CUDA kernel, on a
    CPU tensor it runs the kernel's plain version. ``'auto'`` takes the
    kernel path on both (the JAX package's ``'auto'`` is staged off the
    TPU), so the CPU tests hold the kernels' arithmetic."""
    if kernel not in FAMILIES:
        raise ValueError(f"unknown kernel family {kernel!r}; the families "
                         f"are {FAMILIES}")
    if pallas_disabled(explicit=use_pallas is True, kernel=kernel):
        return False
    return use_pallas is not False


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
