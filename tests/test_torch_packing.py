"""The port's sub-byte packers against the JAX package's, byte for byte.

Codes are made with numpy from a seed and handed to both packages, at
every declared width and at ragged lengths (a shared, zero-padded final
byte; 3-bit codes straddling bytes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grace_tpu.ops import packing as jpacking
from grace_tpu_torch.ops import packing

LENGTHS = [1, 3, 7, 8, 9, 17, 1001]
JAX_PACKERS = {w: (p, u) for w, p, u in jpacking.pack_widths()}


def test_declared_widths_match_jax():
    assert [w for w, _, _ in packing.pack_widths()] == \
        [w for w, _, _ in jpacking.pack_widths()] == [1, 2, 3, 4]


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_pack_matches_jax_byte_for_byte(width, n):
    rng = np.random.default_rng(width * 1000 + n)
    codes = rng.integers(0, 1 << width, n).astype(np.uint8)
    if width == 1:
        codes = codes.astype(bool)
    pack, unpack = packing.PACKERS[width]
    got = pack(torch.from_numpy(codes))
    want = np.asarray(JAX_PACKERS[width][0](jnp.asarray(codes)))
    assert got.dtype == torch.uint8
    assert got.shape[0] == -(-n * width // 8)       # ceil(n*w/8) exactly
    np.testing.assert_array_equal(got.numpy(), want)
    back = unpack(got, n)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JAX_PACKERS[width][1](jnp.asarray(want), n)))
    np.testing.assert_array_equal(back.numpy(), codes)


def test_three_bit_codes_straddle_bytes():
    # Code 1 = 0b111 occupies stream bits 3..5; code 2 = 0b101 bits 6..8.
    got = packing.pack_3bit(torch.tensor([0, 7, 5], dtype=torch.uint8))
    assert got.tolist() == [0b01111000, 0b00000001]
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jpacking.pack_3bit(jnp.asarray([0, 7, 5], jnp.uint8))))
