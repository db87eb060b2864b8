"""Quantize and sign-pack kernels: QSGD's stochastic levels, QSGD's packed
sub-byte wire, and signSGD's packed sign mask.

Counterpart of the JAX package's ``ops/pallas_quant.py``. Each function
comes three ways, in the pattern of ``ops/chunk_topk.py``:

* ``*_plain`` — the plain PyTorch version, the kernel's oracle, and what
  runs for tensors on the CPU;
* the wrapper (``quantize_stochastic``, ``quantize_pack_stochastic``,
  ``sign_pack``) — for CUDA tensors it launches the hand-written kernel of
  ``grace_tpu_torch/csrc/quant.cu`` on the current stream, or raises; for
  CPU tensors it runs the plain version;
* a launch counter, ``<wrapper>.launches``, that the wrapper adds one to
  where it launches its kernel, and nowhere else.

The random bits are :func:`hash_bits_plain`, the counter hash that the
Pallas kernels run off-TPU: the TPU's hardware PRNG stream is not
reproducible anywhere else. The Pallas kernels hash over ``(64, 256)``
blocks with ``block_seed = seed + block_id``, so flat element ``g`` draws
with the local counter ``g % 16384`` and the seed ``seed + g // 16384``,
whatever block shape the CUDA kernel uses. Seeds and hashes are uint32
arithmetic (the bits of XLA's int32 wrap).

``norm`` stays a device tensor (the encode scale ``q / norm`` is computed
on the device with an IEEE division) and ``seed`` is a Python int, so no
call here waits on the device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from grace_tpu_torch.ops import _build
from grace_tpu_torch.ops.packing import PACKERS, pack_bits

# The Pallas kernels' hash block: (ROWS_PER_BLOCK, LANES) = (64, 256).
HASH_BLOCK = 64 * 256
_M32 = 0xFFFFFFFF
_LEVEL_DTYPES = (torch.int8, torch.int16)
PACK_WIDTHS = (2, 3, 4)
SIGN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def hash_bits_plain(seed: int, n: int, device) -> torch.Tensor:
    """The uint32 random bits of flat elements ``0..n-1`` (as int64), the
    counter hash of the Pallas kernels' ``_hash_bits`` over their
    ``(64, 256)`` blocks."""
    g = torch.arange(n, dtype=torch.int64, device=device)
    h = ((g % HASH_BLOCK) * 2654435761) & _M32
    h = (h + ((seed + g // HASH_BLOCK) & _M32)) & _M32
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & _M32
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & _M32
    return h ^ (h >> 16)


def encode_scale_plain(norm: torch.Tensor, quantum_num: int) -> torch.Tensor:
    """``q / norm`` where ``norm > 0``, else 0, as a true IEEE division
    (``q / tensor`` in torch is a reciprocal times ``q``, which differs)."""
    q = torch.full_like(norm, float(quantum_num), dtype=torch.float32)
    scale = torch.div(q, norm.float())
    return torch.where(norm > 0, scale, torch.zeros_like(scale))


def hash_uniforms_plain(seed: int, n: int, device) -> torch.Tensor:
    """The kernels' float32 uniforms in ``[0, 1)``: the top 24 bits of
    :func:`hash_bits_plain`, exact in float32."""
    bits = hash_bits_plain(seed, n, device)
    return (bits >> 8).to(torch.int32).to(torch.float32) * (1.0 / (1 << 24))


def signed_levels_plain(flat: torch.Tensor, norm: torch.Tensor,
                        u: torch.Tensor, quantum_num: int) -> torch.Tensor:
    """The QSGD stochastic-rounding core, op for op after the Pallas
    ``_signed_levels``: float32 signed levels of ``flat``, rounding up
    where the uniform ``u`` falls below the fraction. The kernels' plain
    versions pass :func:`hash_uniforms_plain`; QSGD's staged path passes
    ``torch.rand``."""
    x = flat.float()
    scale = encode_scale_plain(norm, quantum_num)
    level_float = x.abs() * scale
    previous = torch.floor(level_float)
    level = previous + (u < level_float - previous).to(torch.float32)
    return level * torch.sign(x)


def saturate_levels_plain(signed: torch.Tensor, out_dtype) -> torch.Tensor:
    """Float levels to the int8/int16 wire; the conversion saturates, as
    XLA's does."""
    info = torch.iinfo(out_dtype)
    return signed.clamp(info.min, info.max).to(out_dtype)


def pack_levels_plain(signed: torch.Tensor, quantum_num: int,
                      width: int) -> torch.Tensor:
    """Float levels to the packed wire: clamped to ``±quantum_num``, folded
    into ``width``-bit two's complement and packed LSB-first."""
    q = float(quantum_num)
    signed = signed.clamp(-q, q)
    codes = signed + float(1 << width) * (signed < 0).to(torch.float32)
    return PACKERS[width][0](codes.to(torch.uint8))


def _check_flat(name: str, flat: torch.Tensor, norm: torch.Tensor):
    if flat.dim() != 1 or not flat.is_floating_point():
        raise ValueError(f"{name} takes a flat float tensor; got {flat.dtype} "
                         f"of shape {tuple(flat.shape)}")
    if norm.numel() != 1 or norm.device != flat.device:
        raise ValueError(f"{name}: norm must be one element on {flat.device}")


def _check_pack(quantum_num: int, width: int):
    if width not in PACK_WIDTHS:
        raise ValueError(f"width must be 2, 3 or 4; got {width}")
    if quantum_num > (1 << (width - 1)) - 1:
        raise ValueError(
            f"quantize_pack_stochastic packs {width}-bit two's-complement "
            f"levels (magnitude <= {(1 << (width - 1)) - 1}); "
            f"quantum_num={quantum_num} cannot fit: use a wider pack or "
            "quantize_stochastic (int8/int16 wire) instead.")


def quantize_stochastic_plain(flat: torch.Tensor, norm: torch.Tensor,
                              seed: int, quantum_num: int,
                              out_dtype=torch.int8) -> torch.Tensor:
    """QSGD levels ``floor(|x|·q/‖x‖) + Bernoulli(frac)`` with the sign
    folded in, as ``out_dtype`` (int8 or int16); the plain version of the
    kernel. The float-to-int conversion saturates, as XLA's does."""
    _check_flat("quantize_stochastic", flat, norm)
    if out_dtype not in _LEVEL_DTYPES:
        raise ValueError(f"out_dtype must be int8 or int16; got {out_dtype}")
    u = hash_uniforms_plain(seed, flat.numel(), flat.device)
    return saturate_levels_plain(
        signed_levels_plain(flat, norm.reshape(()), u, quantum_num),
        out_dtype)


def quantize_pack_stochastic_plain(flat: torch.Tensor, norm: torch.Tensor,
                                   seed: int, quantum_num: int,
                                   width: int = 4) -> torch.Tensor:
    """The same levels clamped to ``±quantum_num``, folded into
    ``width``-bit two's complement and packed LSB-first:
    ``ceil(n·width/8)`` uint8 bytes; the plain version of the kernel."""
    _check_flat("quantize_pack_stochastic", flat, norm)
    _check_pack(quantum_num, width)
    u = hash_uniforms_plain(seed, flat.numel(), flat.device)
    return pack_levels_plain(
        signed_levels_plain(flat, norm.reshape(()), u, quantum_num),
        quantum_num, width)


def sign_pack_plain(flat: torch.Tensor) -> torch.Tensor:
    """``flat >= 0`` packed 8 per byte, LSB-first (−0.0 gives 1, NaN 0);
    the plain version of the kernel."""
    if flat.dim() != 1 or flat.dtype not in SIGN_DTYPES:
        raise ValueError(f"sign_pack takes a flat float32/bfloat16/float16 "
                         f"tensor; got {flat.dtype} of shape "
                         f"{tuple(flat.shape)}")
    return pack_bits(flat >= 0)


# -- CUDA wrappers -----------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as void*, so ctypes never truncates them to 32 bits)."""
    lib = _build.library("quant")
    p, i64, i32, u32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_uint32)
    lib.grace_quantize_stochastic.argtypes = [p, p, p, i64, i32, u32, i32, p]
    lib.grace_quantize_stochastic.restype = ctypes.c_int
    lib.grace_quantize_pack_stochastic.argtypes = [p, p, p, i64, i32, u32,
                                                   i32, p]
    lib.grace_quantize_pack_stochastic.restype = ctypes.c_int
    lib.grace_sign_pack.argtypes = [p, p, i64, i32, p]
    lib.grace_sign_pack.restype = ctypes.c_int
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")


def _cuda_inputs(name: str, flat: torch.Tensor, norm: torch.Tensor):
    """(float32 contiguous flat, float32 norm) on the card, or raise."""
    if flat.device.type != "cuda":
        raise ValueError(f"no {name} for {flat.device}")
    _check_flat(name, flat, norm)
    # The kernel reads float32; other float gradients take one cast pass.
    flat = flat.float().contiguous()
    return flat, norm.float().contiguous()


def quantize_stochastic(flat: torch.Tensor, norm: torch.Tensor, seed: int,
                        quantum_num: int, out_dtype=torch.int8
                        ) -> torch.Tensor:
    """Stochastically quantize ``flat`` to signed int8/int16 QSGD levels
    (``norm``: its L2 norm, one element on its device; ``seed``: a Python
    int, taken as uint32). Bit-identical to
    :func:`quantize_stochastic_plain`."""
    if flat.device.type == "cpu":
        return quantize_stochastic_plain(flat, norm, seed, quantum_num,
                                         out_dtype)
    flat, norm = _cuda_inputs("quantize_stochastic", flat, norm)
    if out_dtype not in _LEVEL_DTYPES:
        raise ValueError(f"out_dtype must be int8 or int16; got {out_dtype}")
    out = torch.empty(flat.numel(), dtype=out_dtype, device=flat.device)
    if flat.numel():
        with torch.cuda.device(flat.device):
            err = _lib().grace_quantize_stochastic(
                flat.data_ptr(), norm.data_ptr(), out.data_ptr(),
                flat.numel(), int(quantum_num), seed & _M32,
                int(out_dtype == torch.int16),
                torch.cuda.current_stream(flat.device).cuda_stream)
        _raise_on(err, "quantize_stochastic")
        quantize_stochastic.launches += 1
    return out


quantize_stochastic.launches = 0


def quantize_pack_stochastic(flat: torch.Tensor, norm: torch.Tensor,
                             seed: int, quantum_num: int, width: int = 4
                             ) -> torch.Tensor:
    """Fused QSGD compress-and-pack: the packed ``width``-bit wire bytes
    (``ceil(n·width/8)`` uint8) in one pass, with no full-width
    intermediate. Bit-identical to :func:`quantize_pack_stochastic_plain`."""
    if flat.device.type == "cpu":
        return quantize_pack_stochastic_plain(flat, norm, seed, quantum_num,
                                              width)
    flat, norm = _cuda_inputs("quantize_pack_stochastic", flat, norm)
    _check_pack(quantum_num, width)
    n = flat.numel()
    out = torch.empty(-(-n * width // 8), dtype=torch.uint8,
                      device=flat.device)
    if n:
        with torch.cuda.device(flat.device):
            err = _lib().grace_quantize_pack_stochastic(
                flat.data_ptr(), norm.data_ptr(), out.data_ptr(), n,
                int(quantum_num), seed & _M32, int(width),
                torch.cuda.current_stream(flat.device).cuda_stream)
        _raise_on(err, "quantize_pack_stochastic")
        quantize_pack_stochastic.launches += 1
    return out


quantize_pack_stochastic.launches = 0


def sign_pack(flat: torch.Tensor) -> torch.Tensor:
    """The sign mask ``flat >= 0`` packed 8 per byte, LSB-first, read
    straight from float32, bfloat16 or float16 (no cast pass).
    Bit-identical to :func:`sign_pack_plain`."""
    if flat.device.type == "cpu":
        return sign_pack_plain(flat)
    if flat.device.type != "cuda":
        raise ValueError(f"no sign_pack for {flat.device}")
    if flat.dim() != 1 or flat.dtype not in SIGN_DTYPES:
        raise ValueError(f"sign_pack takes a flat float32/bfloat16/float16 "
                         f"tensor; got {flat.dtype} of shape "
                         f"{tuple(flat.shape)}")
    flat = flat.contiguous()
    n = flat.numel()
    out = torch.empty(-(-n // 8), dtype=torch.uint8, device=flat.device)
    if n:
        with torch.cuda.device(flat.device):
            err = _lib().grace_sign_pack(
                flat.data_ptr(), out.data_ptr(), n,
                SIGN_DTYPES.index(flat.dtype),
                torch.cuda.current_stream(flat.device).cuda_stream)
        _raise_on(err, "sign_pack")
        sign_pack.launches += 1
    return out


sign_pack.launches = 0


def reset_launch_counts() -> None:
    quantize_stochastic.launches = 0
    quantize_pack_stochastic.launches = 0
    sign_pack.launches = 0
