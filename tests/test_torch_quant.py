"""The plain versions of the port's quantize, quantize-and-pack and sign-pack
kernels against the JAX Pallas kernels in interpret mode, bit for bit.

Inputs are made with numpy from a seed; both packages get the same flat
tensor, the same ``norm`` and the same ``seed`` (the kernels' random bits
are the counter hash of ``pallas_quant._hash_bits``, so equal seeds give
equal draws). On the CPU the port's wrappers run the plain versions, which
is what the CUDA kernels are held to on the card (``chip_smoke.py``).

Non-finite inputs are outside the contract: a NaN or infinite gradient
element has no defined QSGD level (XLA and torch convert a NaN level to an
integer differently), so the quantize cases use finite inputs only. The
sign mask is defined for them (NaN gives 0, -0.0 gives 1) and is tested.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grace_tpu.ops import pallas_quant
from grace_tpu_torch.ops import quant

# The lengths straddle the Pallas (64, 256) hash block of 16384 elements.
LENGTHS = [1, 7, 8, 16383, 16384, 16385, 40000]
LEVELS = [1, 3, 7, 64, 127, 200]          # 200: the int16 wire
BIG_SEED = 2**31 - 2                      # seed + block id wraps int32


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _jax_quantize(x, norm, seed, q):
    dt = jnp.int8 if q < 128 else jnp.int16
    return np.asarray(pallas_quant.quantize_stochastic(
        jnp.asarray(x), jnp.asarray(norm), jnp.asarray(seed, jnp.int32), q,
        out_dtype=dt, interpret=True))


def _port_quantize(x, norm, seed, q):
    dt = torch.int8 if q < 128 else torch.int16
    return quant.quantize_stochastic(torch.from_numpy(x), torch.tensor(norm),
                                     seed, q, dt).numpy()


def test_hash_bits_match_pallas():
    # The (64, 256) block of one grid step, and the seeds of later blocks.
    for seed in (0, 7, BIG_SEED):
        for block in (0, 1, 2):
            block_seed = jnp.asarray(seed, jnp.int32) + jnp.int32(block)
            want = np.asarray(pallas_quant._hash_bits(block_seed, (64, 256)))
            got = quant.hash_bits_plain(seed, 3 * 16384, "cpu")
            np.testing.assert_array_equal(
                got[block * 16384:(block + 1) * 16384].numpy(),
                want.reshape(-1).astype(np.int64))


@pytest.mark.parametrize("q", LEVELS)
@pytest.mark.parametrize("n", LENGTHS)
def test_quantize_matches_pallas_interpret(n, q):
    x = _x(n, seed=n)
    norm = np.float32(np.linalg.norm(x))
    seed = 12345 + q
    got, want = _port_quantize(x, norm, seed, q), _jax_quantize(x, norm, seed, q)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q", [3, 127, 200])
def test_quantize_edge_cases_match_pallas(q):
    x = _x(16385, seed=1)
    # A zero norm quantizes everything to 0; a seed near 2^31 - 1 wraps.
    for norm, seed in ((np.float32(0), 5), (np.float32(np.linalg.norm(x)),
                                            BIG_SEED)):
        got, want = (_port_quantize(x, norm, seed, q),
                     _jax_quantize(x, norm, seed, q))
        np.testing.assert_array_equal(got, want)
    assert not _port_quantize(x, np.float32(0), 5, q).any()


def _pack_cases():
    """Every length at each q's narrowest width; the wider widths (a small
    q in a wide field) at the two multi-block lengths."""
    for n in LENGTHS:
        for q in (1, 3, 7):
            narrowest = 2 if q <= 1 else 3 if q <= 3 else 4
            widths = range(narrowest, 5) if n in (16385, 40000) else \
                (narrowest,)
            for width in widths:
                yield n, q, width


@pytest.mark.parametrize("n,q,width", list(_pack_cases()))
def test_quantize_pack_matches_pallas_interpret(n, q, width):
    x = _x(n, seed=n + 1)
    norm = np.float32(np.linalg.norm(x))
    seed = 999 + width
    want = np.asarray(pallas_quant.quantize_pack_stochastic(
        jnp.asarray(x), jnp.asarray(norm), jnp.asarray(seed, jnp.int32), q,
        width=width, interpret=True))
    got = quant.quantize_pack_stochastic(torch.from_numpy(x),
                                         torch.tensor(norm), seed, q, width)
    assert got.dtype == torch.uint8 and got.shape[0] == -(-n * width // 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", [2, 3, 4])
def test_quantize_pack_edge_cases_match_pallas(width):
    q = (1 << (width - 1)) - 1
    x = _x(16385, seed=2)
    for norm, seed in ((np.float32(0), 3), (np.float32(np.linalg.norm(x)),
                                            BIG_SEED)):
        want = np.asarray(pallas_quant.quantize_pack_stochastic(
            jnp.asarray(x), jnp.asarray(norm), jnp.asarray(seed, jnp.int32),
            q, width=width, interpret=True))
        got = quant.quantize_pack_stochastic(torch.from_numpy(x),
                                             torch.tensor(norm), seed, q,
                                             width)
        np.testing.assert_array_equal(got.numpy(), want)


# Codes around the CUDA kernel's 32-bit words (16 codes at width 2, 8 at
# width 4, 32 codes = 3 words at width 3) and its 128-code rows.
VIEW_LENGTHS = [7, 8, 9, 15, 16, 17, 31, 32, 33, 127, 129]


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("width", [2, 3, 4])
def test_quantize_pack_of_shard_views_matches_pallas(width, offset):
    # A ring shard is a view at any element offset of its buffer: offsets
    # 1-3 do not start on the 16-byte boundary that the card's vector loads
    # need, so the kernel reads their head with scalar loads.
    q = (1 << (width - 1)) - 1
    for n in VIEW_LENGTHS:
        base = torch.from_numpy(_x(n + offset, seed=100 * width + n))
        view = base[offset:]
        assert view.storage_offset() == offset
        x = view.numpy()
        norm = np.float32(np.linalg.norm(x))
        seed = 31 * n + offset
        want = np.asarray(pallas_quant.quantize_pack_stochastic(
            jnp.asarray(x), jnp.asarray(norm), jnp.asarray(seed, jnp.int32),
            q, width=width, interpret=True))
        got = quant.quantize_pack_stochastic(view, torch.tensor(norm), seed,
                                             q, width)
        assert got.shape[0] == -(-n * width // 8)
        np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_pack_is_quantize_then_pack():
    # The fused pack equals the plain levels clamped, folded and packed.
    from grace_tpu_torch.ops.packing import PACKERS
    x = torch.from_numpy(_x(1001, seed=4))
    norm = torch.linalg.vector_norm(x)
    levels = quant.quantize_stochastic(x, norm, 77, 7).to(torch.int16)
    codes = torch.where(levels.clamp(-7, 7) < 0, levels.clamp(-7, 7) + 16,
                        levels.clamp(-7, 7))
    np.testing.assert_array_equal(
        quant.quantize_pack_stochastic(x, norm, 77, 7, 4).numpy(),
        PACKERS[4][0](codes).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n", LENGTHS)
def test_sign_pack_matches_pallas_interpret(n, dtype):
    x = _x(n, seed=n + 2)
    x[:3] = np.array([0.0, -0.0, np.nan], np.float32)[:min(n, 3)]
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(pallas_quant.sign_pack(xj, interpret=True))
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = quant.sign_pack(xt)
    assert got.shape[0] == -(-n // 8)
    np.testing.assert_array_equal(got.numpy(), want)
    if n >= 3:                            # +0.0 -> 1, -0.0 -> 1, NaN -> 0
        assert got[0].item() & 0b111 == 0b011


def test_wrappers_take_plain_versions_only_on_cpu():
    x = torch.from_numpy(_x(100))
    norm = torch.linalg.vector_norm(x)
    before = (quant.quantize_stochastic.launches,
              quant.quantize_pack_stochastic.launches, quant.sign_pack.launches)
    quant.quantize_stochastic(x, norm, 1, 64)
    quant.quantize_pack_stochastic(x, norm, 1, 7)
    quant.sign_pack(x)
    # No kernel ran, so no launch was counted.
    assert (quant.quantize_stochastic.launches,
            quant.quantize_pack_stochastic.launches,
            quant.sign_pack.launches) == before
    with pytest.raises(ValueError, match="cannot fit"):
        quant.quantize_pack_stochastic(x, norm, 1, 7, width=3)
    with pytest.raises(ValueError, match="width"):
        quant.quantize_pack_stochastic(x, norm, 1, 1, width=8)
    with pytest.raises(ValueError, match="int8 or int16"):
        quant.quantize_stochastic(x, norm, 1, 64, torch.int32)
    with pytest.raises(ValueError):
        quant.sign_pack(x.double())
    with pytest.raises(ValueError):
        quant.sign_pack(x.to("meta"))
