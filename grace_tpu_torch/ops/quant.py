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

The sign-pack kernel also has a grouped wrapper, :func:`sign_pack_grouped`
(with :func:`sign_pack_grouped_plain` and its own counter): one launch over
up to ``MAX_LEAVES_PER_LAUNCH`` leaves, with linear error feedback folded
in, into one payload whose leaf segments start on 16-byte boundaries
(:class:`SignPlan`). The one-leaf :func:`sign_pack` is its one-leaf case
without feedback.

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

import contextlib
import ctypes
import dataclasses
import functools
import operator
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from grace_tpu_torch.ops import _build
from grace_tpu_torch.ops import fake as _fake
from grace_tpu_torch.ops.packing import PACKERS, pack_bits, unpack_bits

# The Pallas kernels' hash block: (ROWS_PER_BLOCK, LANES) = (64, 256).
HASH_BLOCK = 64 * 256
_M32 = 0xFFFFFFFF
_LEVEL_DTYPES = (torch.int8, torch.int16)
PACK_WIDTHS = (2, 3, 4)
SIGN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# The sign-pack kernel's leaf table capacity, words a block and the
# alignment of each leaf's payload segment (csrc/quant.cu kMaxLeaves,
# kSignTileWords).
MAX_LEAVES_PER_LAUNCH = 256
SIGN_TILE_WORDS = 128
SIGN_ALIGN = 16
# quantize-and-pack writes whole rows of 128 codes: 16 * width bytes each.
PACK_ROW = 128


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
    _sign_check(flat)
    return pack_bits(flat >= 0)


def _sign_check(flat: torch.Tensor) -> None:
    if flat.dim() != 1 or flat.dtype not in SIGN_DTYPES:
        raise ValueError(f"sign_pack takes a flat float32/bfloat16/float16 "
                         f"tensor; got {flat.dtype} of shape "
                         f"{tuple(flat.shape)}")


# -- the grouped sign-pack: many leaves, one payload -------------------------

@dataclasses.dataclass(frozen=True)
class SignPlan:
    """Where each leaf of a grouped sign-pack lives, from its size alone.

    ``boff``: leaf ``l``'s byte offset in the concatenated payload, a
    multiple of ``SIGN_ALIGN``, with the total at index ``L``; its segment
    holds ``ceil(n/128) * 16`` bytes, of which its wire payload is the
    first ``ceil(n/8)``. ``tile0``: its first tile of ``SIGN_TILE_WORDS``
    words. ``launches``: the ``[lo, hi)`` leaf spans of the kernel
    launches, at most ``MAX_LEAVES_PER_LAUNCH`` leaves each.
    """

    ns: Tuple[int, ...]
    boff: np.ndarray
    tile0: np.ndarray
    launches: Tuple[Tuple[int, int], ...]
    _tables: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    @property
    def nbytes(self) -> int:
        return int(self.boff[-1])

    def table(self, lo: int, hi: int) -> np.ndarray:
        """A fresh copy of the kernel's leaf table for the launch over
        leaves ``[lo, hi)``: three zeroed pointer words and a zeroed dtype
        a row, then n, the byte offset and the first tile counted from the
        launch's first leaf (byte offsets stay global: the payload pointer
        is the whole buffer's)."""
        key = (lo, hi)
        if key not in self._tables:
            rows = np.zeros((hi - lo, 7), dtype=np.int64)
            rows[:, 3] = self.ns[lo:hi]
            rows[:, 5] = self.boff[lo:hi]
            rows[:, 6] = self.tile0[lo:hi] - self.tile0[lo]
            self._tables[key] = rows
        return self._tables[key].copy()

    def views(self, payload: torch.Tensor) -> list:
        """Each leaf's wire payload: its first ``ceil(n/8)`` bytes."""
        return [payload[o:o + -(-n // 8)]
                for o, n in zip(self.boff.tolist(), self.ns)]


@functools.lru_cache(maxsize=64)
def sign_plan(ns: Tuple[int, ...]) -> SignPlan:
    """The cached :class:`SignPlan` of leaves of sizes ``ns``."""
    if not ns or any(n < 1 for n in ns):
        raise ValueError(f"a sign plan needs leaves of at least one element; "
                         f"got sizes {ns[:8]}")
    seg = [-(-n // PACK_ROW) * SIGN_ALIGN for n in ns]      # bytes
    tiles = [-(-(s // 4) // SIGN_TILE_WORDS) for s in seg]
    launches = tuple((lo, min(lo + MAX_LEAVES_PER_LAUNCH, len(ns)))
                     for lo in range(0, len(ns), MAX_LEAVES_PER_LAUNCH))
    return SignPlan(tuple(ns), _prefix(seg), _prefix(tiles), launches)


def _prefix(xs) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(xs, dtype=np.int64)])


def sign_pack_grouped_plain(grads: Sequence[torch.Tensor],
                            residuals: Optional[Sequence[torch.Tensor]] = None,
                            beta: float = 1.0, gamma: float = 1.0):
    """The plain version of the grouped sign-pack: per leaf, the staged
    error-feedback pipeline of ``ResidualMemory`` around signSGD's pack —
    ``comp = beta*residual + gamma*grad`` (``comp = grad`` without
    residuals), ``pack_bits(comp >= 0)``, and the new residual ``comp -
    (±1)`` — into one zero-padded payload laid out by :func:`sign_plan`.
    Returns ``(payload, new residuals or None)``."""
    plan = sign_plan(tuple(g.numel() for g in grads))
    dev = grads[0].device
    payload = torch.zeros(plan.nbytes, dtype=torch.uint8, device=dev)
    views = plan.views(payload)
    new_resids = None if residuals is None else []
    for l, g in enumerate(grads):
        flat = g.reshape(-1)
        _sign_check(flat)
        if residuals is None:
            comp = flat
        else:
            comp = beta * residuals[l].reshape(-1) + gamma * flat
        packed = pack_bits(comp >= 0)
        views[l].copy_(packed)
        if residuals is not None:
            signs = unpack_bits(packed, flat.numel()).to(comp.dtype) * 2 - 1
            new_resids.append((comp - signs).view(residuals[l].shape))
    return payload, new_resids


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
    lib.grace_sign_pack.argtypes = [p, i32, p, ctypes.c_float,
                                    ctypes.c_float, p]
    lib.grace_sign_pack.restype = ctypes.c_int
    return lib


def _fresh(n: int, dtype, device, head: Optional[int] = None):
    """A fake launch's ``(result, written)``: a fresh output of ``n``
    elements, the result its first ``head`` where given (the wire payload
    at the head of a padded buffer)."""
    out = torch.empty(n, dtype=dtype, device=device)
    return (out if head is None else out[:head]), (out,)


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
    if _fake.is_fake(flat) and flat.numel():
        return _fake.launch("quantize_stochastic", [flat, norm],
                            lambda: _fresh(flat.numel(), out_dtype,
                                           flat.device))
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
    intermediate. ``flat`` may be a view at any element offset (a ring
    shard): the kernel reads it in place. On CUDA the bytes are the head of
    a buffer of whole 128-code rows. Bit-identical to
    :func:`quantize_pack_stochastic_plain`."""
    if flat.device.type == "cpu":
        return quantize_pack_stochastic_plain(flat, norm, seed, quantum_num,
                                              width)
    flat, norm = _cuda_inputs("quantize_pack_stochastic", flat, norm)
    _check_pack(quantum_num, width)
    n = flat.numel()
    # The kernel stores whole 32-bit words of whole 128-code rows; the wire
    # payload is the first ceil(n * width / 8) bytes.
    if _fake.is_fake(flat) and n:
        return _fake.launch(
            "quantize_pack_stochastic", [flat, norm],
            lambda: _fresh(-(-n // PACK_ROW) * 16 * width, torch.uint8,
                           flat.device, -(-n * width // 8)))
    out = torch.empty(-(-n // PACK_ROW) * 16 * width, dtype=torch.uint8,
                      device=flat.device)
    if n:
        with torch.cuda.device(flat.device):
            err = _lib().grace_quantize_pack_stochastic(
                flat.data_ptr(), norm.data_ptr(), out.data_ptr(), n,
                int(quantum_num), seed & _M32, int(width),
                torch.cuda.current_stream(flat.device).cuda_stream)
        _raise_on(err, "quantize_pack_stochastic")
        quantize_pack_stochastic.launches += 1
    return out[:-(-n * width // 8)]


quantize_pack_stochastic.launches = 0


def _launch_sign(rows: np.ndarray, payload: torch.Tensor, beta: float,
                 gamma: float) -> None:
    dev = payload.device
    # A device switch only where dev is not current: entering one costs
    # microseconds a call.
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        err = _lib().grace_sign_pack(
            rows.ctypes.data, rows.shape[0], payload.data_ptr(), float(beta),
            float(gamma), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "sign_pack")


def sign_pack(flat: torch.Tensor) -> torch.Tensor:
    """The sign mask ``flat >= 0`` packed 8 per byte, LSB-first, read
    straight from float32, bfloat16 or float16 (no cast pass): the
    grouped kernel over a one-leaf table, without feedback.
    Bit-identical to :func:`sign_pack_plain`."""
    if flat.device.type == "cpu":
        return sign_pack_plain(flat)
    if flat.device.type != "cuda":
        raise ValueError(f"no sign_pack for {flat.device}")
    _sign_check(flat)
    flat = flat.contiguous()
    n = flat.numel()
    if not n:
        return torch.empty(0, dtype=torch.uint8, device=flat.device)
    plan = sign_plan((n,))
    if _fake.is_fake(flat):
        return _fake.launch("sign_pack", [flat],
                            lambda: _fresh(plan.nbytes, torch.uint8,
                                           flat.device, -(-n // 8)))
    payload = torch.empty(plan.nbytes, dtype=torch.uint8, device=flat.device)
    rows = plan.table(0, 1)
    rows[0, 0] = flat.data_ptr()
    rows[0, 4] = SIGN_DTYPES.index(flat.dtype)
    _launch_sign(rows, payload, 1.0, 1.0)
    sign_pack.launches += 1
    return payload[:-(-n // 8)]


sign_pack.launches = 0

_dtype = operator.attrgetter("dtype")


def sign_pack_grouped(grads: Sequence[torch.Tensor],
                      residuals: Optional[Sequence[torch.Tensor]] = None,
                      beta: float = 1.0, gamma: float = 1.0):
    """signSGD's sign-pack over many leaves in one launch (one per
    ``MAX_LEAVES_PER_LAUNCH`` leaves), with linear error feedback folded in.

    ``grads``: contiguous leaves of any shape (their flat order is packed),
    float32, bfloat16 or float16 without residuals, float32 with them;
    ``residuals``: None (``comp = grad``), or a contiguous float32 residual
    of each leaf's size (``comp = beta*residual + gamma*grad``, and the new
    residual ``comp - (±1)``). Returns ``(payload, new_residuals)``: the
    concatenated uint8 payload laid out by :func:`sign_plan` (every leaf's
    segment starts on a 16-byte boundary, padding bits 0; each leaf's wire
    payload, in the one-leaf format, is the view ``SignPlan.views`` gives),
    and the new residuals (None without residuals). Bit-identical to
    :func:`sign_pack_grouped_plain`.

    On CUDA every new residual is written over its residual IN PLACE, as
    ``chunk_compress_feedback_grouped`` does: ``new_residuals[l]`` is
    ``residuals[l]`` itself. Clone the residuals first to keep the old ones.
    """
    if grads[0].device.type == "cpu":
        return sign_pack_grouped_plain(grads, residuals, beta, gamma)
    if grads[0].device.type != "cuda":
        raise ValueError(f"no sign_pack_grouped for {grads[0].device}")
    dev = grads[0].device
    ns = tuple(map(torch.Tensor.numel, grads))
    plan = sign_plan(ns)
    tensors = list(grads) + list(residuals or ())
    dtypes = set(map(_dtype, tensors))
    devices = set(map(torch.Tensor.get_device, tensors))
    contiguous = all(map(torch.Tensor.is_contiguous, tensors))
    sizes = residuals is None or tuple(map(torch.Tensor.numel,
                                           residuals)) == ns
    allowed = {torch.float32} if residuals is not None else set(SIGN_DTYPES)
    if (not dtypes <= allowed or devices != {dev.index} or not contiguous
            or not sizes):
        raise ValueError(
            "sign_pack_grouped takes contiguous float32/bfloat16/float16 "
            "leaves (float32 with residuals) and float32 residuals of their "
            f"sizes on {dev}; got dtypes {sorted(map(str, dtypes))}, devices "
            f"{sorted(devices)}, all contiguous {contiguous}, residual sizes "
            f"matching {sizes}")
    if _fake.is_fake(grads[0]):
        def outputs():
            payload = torch.empty(plan.nbytes, dtype=torch.uint8, device=dev)
            new = None if residuals is None else list(residuals)
            return (payload, new), [payload] + (new or [])

        return _fake.launch("sign_pack", tensors, outputs)
    payload = torch.empty(plan.nbytes, dtype=torch.uint8, device=dev)
    gptr = list(map(torch.Tensor.data_ptr, grads))
    # The table's dtype column is 0 (float32) unless a leaf is narrower.
    kinds = (None if dtypes == {torch.float32} else
             [SIGN_DTYPES.index(g.dtype) for g in grads])
    rptr = (list(map(torch.Tensor.data_ptr, residuals))
            if residuals is not None else None)
    for lo, hi in plan.launches:
        rows = plan.table(lo, hi)
        rows[:, 0] = gptr[lo:hi]
        if rptr is not None:
            rows[:, 1] = rptr[lo:hi]
            rows[:, 2] = rptr[lo:hi]
        if kinds is not None:
            rows[:, 4] = kinds[lo:hi]
        _launch_sign(rows, payload, beta, gamma)
        sign_pack_grouped.launches += 1
    return payload, None if residuals is None else list(residuals)


sign_pack_grouped.launches = 0


def reset_launch_counts() -> None:
    for f in (quantize_stochastic, quantize_pack_stochastic, sign_pack,
              sign_pack_grouped):
        f.launches = 0


def launch_counts() -> dict:
    """Launches of each kernel, by kernel name: the one-leaf and grouped
    sign-pack wrappers launch the same kernel, so their counts add."""
    return {"quantize_stochastic": quantize_stochastic.launches,
            "quantize_pack_stochastic": quantize_pack_stochastic.launches,
            "sign_pack": sign_pack.launches + sign_pack_grouped.launches}
