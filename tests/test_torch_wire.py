"""The plain versions of the port's decode→accumulate and packed integer
accumulate kernels against the JAX Pallas kernels in interpret mode, and
against the staged paths they fuse.

A finding pins the shape of these tests: in interpret mode XLA's CPU
backend contracts the scaled accumulate ``acc + scale_k * level_k`` into
fused multiply-adds (one rounding where the staged decode rounds twice).
The port's kernel and its plain version round the product and the sum
each on their own, which is the staged decode's definition. So:

* at every width, K, ``sign`` and ``vote``, with power-of-two scales (every
  product exact, so a contraction cannot change a bit), the plain version
  equals the interpret-mode kernel bit for bit;
* with arbitrary scales it equals the staged decode run op by op (JAX
  eager: each product and sum rounded) bit for bit, and the interpret-mode
  kernel equals the contracted sum exactly, within one rounding a payload.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grace_tpu.ops import packing as jpacking
from grace_tpu.ops import pallas_wire
from grace_tpu_torch.ops import wire
from grace_tpu_torch.ops.packing import PACKERS

NUMELS = [7, 1000, 16385]
MODES = [(w, False, False) for w in (1, 2, 3, 4)] + [(1, True, False),
                                                     (1, True, True)]
JAX_UNPACK = {w: u for w, _, u in jpacking.pack_widths()}


def _payloads(numel, width, k, seed, pow2=True):
    rng = np.random.default_rng(seed)
    stacked = rng.integers(0, 256, (k, -(-numel * width // 8))).astype(
        np.uint8)
    if pow2:
        scales = (2.0 ** rng.integers(-6, 4, k)).astype(np.float32)
    else:
        scales = (rng.random(k) * 3).astype(np.float32)
    return stacked, scales


def _jax(stacked, scales, numel, width, sign, vote):
    return np.asarray(pallas_wire.decode_accumulate(
        jnp.asarray(stacked), jnp.asarray(scales), numel, width, sign=sign,
        vote=vote, interpret=True))


def _port(stacked, scales, numel, width, sign, vote):
    return wire.decode_accumulate(torch.from_numpy(stacked),
                                  torch.from_numpy(scales), numel, width,
                                  sign, vote).numpy()


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("width,sign,vote", MODES)
@pytest.mark.parametrize("numel", NUMELS)
def test_decode_accumulate_matches_pallas_interpret(numel, width, sign, vote,
                                                    k):
    stacked, scales = _payloads(numel, width, k, seed=numel + 10 * width + k)
    got = _port(stacked, scales, numel, width, sign, vote)
    want = _jax(stacked, scales, numel, width, sign, vote)
    assert got.dtype == np.float32 and got.shape == (numel,)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if vote:
        assert set(np.unique(got)) <= {-1.0, 1.0}


def _staged_eager(stacked, scales, numel, width):
    """The staged sequential decode, op by op in JAX eager mode."""
    acc = None
    for k in range(stacked.shape[0]):
        code = JAX_UNPACK[width](jnp.asarray(stacked[k]), numel).astype(
            jnp.int8)
        level = jnp.where(code >= (1 << (width - 1)), code - (1 << width),
                          code)
        val = jnp.asarray(scales[k]) * level.astype(jnp.float32)
        acc = val if acc is None else acc + val
    return np.asarray(acc)


def _contracted(stacked, scales, numel, width):
    """XLA CPU's contraction, computed exactly: acc = fma(s0, l0, s1*l1),
    then acc = fma(sk, lk, acc)."""
    levels = []
    for k in range(stacked.shape[0]):
        code = np.asarray(JAX_UNPACK[width](jnp.asarray(stacked[k]), numel)
                          ).astype(np.int64)
        levels.append(code - (1 << width) * (code >= (1 << (width - 1))))
    out = np.empty(numel, np.float32)
    s = [Fraction(float(v)) for v in scales]
    for i in range(numel):
        if len(levels) == 1:
            out[i] = np.float32(scales[0] * np.float32(levels[0][i]))
            continue
        acc = np.float32(float(s[0] * int(levels[0][i])
                               + Fraction(float(np.float32(
                                   scales[1] * np.float32(levels[1][i]))))))
        for k in range(2, len(levels)):
            acc = np.float32(float(s[k] * int(levels[k][i])
                                   + Fraction(float(acc))))
        out[i] = acc
    return out


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("width", [2, 3, 4])
def test_decode_accumulate_arbitrary_scales(width, k):
    numel = 1000
    stacked, scales = _payloads(numel, width, k, seed=width * 7 + k,
                                pow2=False)
    got = _port(stacked, scales, numel, width, False, False)
    # Bit for bit with the staged decode, each operation rounded.
    np.testing.assert_array_equal(
        got.view(np.int32),
        _staged_eager(stacked, scales, numel, width).view(np.int32))
    # The interpret-mode kernel is that sum with its multiply-adds fused,
    # exactly; the two differ by at most one rounding a payload.
    want = _jax(stacked, scales, numel, width, False, False)
    np.testing.assert_array_equal(
        want.view(np.int32),
        _contracted(stacked, scales, numel, width).view(np.int32))
    ulp = np.spacing(np.abs(want).max())
    assert np.abs(got - want).max() <= (k - 1) * ulp


@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("width,sign,vote", MODES)
def test_decode_accumulate_row_strided_matches_pallas(width, sign, vote, k):
    """Payload rows at any stride, as the CUDA wrapper reads them in place:
    the rows of ``wire.stack_payloads`` (padded to 16 bytes) and rows 17
    bytes apart give the bits of the contiguous stack, and those equal the
    interpret-mode Pallas kernel's (power-of-two scales)."""
    numel = 1001                       # rows of 126, 251, 376 or 501 bytes
    stacked, scales = _payloads(numel, width, k, seed=100 * k + 10 * width)
    nbytes = stacked.shape[1]
    padded = wire.stack_payloads([torch.from_numpy(r) for r in stacked])
    assert padded.shape == (k, nbytes) and padded.stride(1) == 1
    assert padded.stride(0) % wire.ROW_ALIGN == 0
    assert padded.stride(0) == -(-nbytes // 16) * 16
    wide = torch.zeros((k, nbytes + 17), dtype=torch.uint8)
    wide[:, :nbytes] = torch.from_numpy(stacked)
    want = _jax(stacked, scales, numel, width, sign, vote)
    for st in (torch.from_numpy(stacked), padded, wide[:, :nbytes]):
        got = wire.decode_accumulate(st, torch.from_numpy(scales), numel,
                                     width, sign, vote).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_wrapper_gates_and_plain_only_on_cpu():
    stacked, scales = _payloads(100, 4, 2, seed=0)
    before = wire.decode_accumulate.launches
    _port(stacked, scales, 100, 4, False, False)
    assert wire.decode_accumulate.launches == before
    t = torch.from_numpy(stacked)
    s = torch.from_numpy(scales)
    with pytest.raises(ValueError, match="width"):
        wire.decode_accumulate(t, s, 100, 5)
    with pytest.raises(ValueError, match="sign"):
        wire.decode_accumulate(t, s, 100, 4, sign=True)
    with pytest.raises(ValueError, match="vote"):
        wire.decode_accumulate(t, s, 100, 4, vote=True)
    with pytest.raises(ValueError, match="uint8"):
        wire.decode_accumulate(t[:, :10], s, 100, 4)      # too few bytes
    with pytest.raises(ValueError, match="scales"):
        wire.decode_accumulate(t, s[:1], 100, 4)
    # The packed integer accumulate runs its plain version on the CPU too.
    before = wire.packed_int_accumulate.launches
    out = wire.packed_int_accumulate(t, 100, 4)
    assert out.shape == (t.shape[1],) and out.dtype == torch.uint8
    assert wire.packed_int_accumulate.launches == before


# -- the packed integer accumulate --------------------------------------------

LENGTHS = (1, 7, 8, 9, 531, 16383, 16384, 16385)


def _bounded_levels(rng, k, n, width):
    """``(k, n)`` levels whose K-way sums stay in the ``width``-bit field:
    uniform in ``±(ceil // k)``, or, where that is 0, one nonzero level a
    slot, in ``±ceil`` (``ceil = 2^(width-1) - 1``)."""
    ceil = (1 << (width - 1)) - 1
    q = ceil // k
    if q >= 1:
        return rng.integers(-q, q + 1, (k, n))
    levels = np.zeros((k, n), np.int64)
    levels[rng.integers(0, k, n), np.arange(n)] = rng.integers(-ceil,
                                                                ceil + 1, n)
    return levels


def _pack(levels, width):
    codes = torch.from_numpy(np.mod(levels, 1 << width).astype(np.uint8))
    return torch.stack([PACKERS[width][0](c) for c in codes])


@pytest.mark.parametrize("k", range(1, 8))
@pytest.mark.parametrize("width", [2, 3, 4])
def test_packed_int_accumulate_matches_pallas_interpret(width, k):
    """Byte for byte with the interpret-mode Pallas kernel, called as
    homoqsgd calls it (every code slot of the bytes), on levels bounded to
    the field, over lengths around the byte and 3-byte boundaries (each
    width sees every length across K) and the Pallas block of 16384."""
    rng = np.random.default_rng(10 * width + k)
    for i in range(3):
        n = LENGTHS[(3 * (k - 1) + i) % len(LENGTHS)]
        levels = _bounded_levels(rng, k, n, width)
        stacked = _pack(levels, width)
        slots = stacked.shape[1] * 8 // width
        got = wire.packed_int_accumulate(stacked, slots, width)
        want = pallas_wire.packed_int_accumulate(
            jnp.asarray(stacked.numpy()), slots, width, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # And the packed sum is the true integer sum of the levels.
        sums = wire.packed_int_accumulate_plain(stacked, n, width)
        code = PACKERS[width][1](sums, n).numpy().astype(np.int64)
        code -= (1 << width) * (code >= (1 << (width - 1)))
        np.testing.assert_array_equal(code, levels.sum(0))


@pytest.mark.parametrize("width", [2, 3, 4])
def test_packed_int_accumulate_matches_jax_staged_and_wraps(width):
    """Against JAX homoqsgd's staged ``_packed_accumulate`` (unpack → add →
    ``jnp.mod`` → repack): on bounded levels, and on random bytes whose
    sums leave the field, where both wrap with a floored mod the same way
    (and zero the bits past the last whole 3-bit code)."""
    from grace_tpu import compressors as JC
    staged = JC.HomoQSGDCompressor(quantum_num=1, accum_bits=width,
                                   use_pallas=False)
    rng = np.random.default_rng(width)
    for k, n in ((2, 531), (3, 1000), (7, 97)):
        cases = (_pack(_bounded_levels(rng, k, n, width), width),
                 torch.from_numpy(rng.integers(0, 256, (k, -(-n * width // 8))
                                               ).astype(np.uint8)))
        for stacked in cases:
            slots = stacked.shape[1] * 8 // width
            want = np.asarray(staged._packed_accumulate(
                jnp.asarray(stacked.numpy())))
            got = wire.packed_int_accumulate(stacked, slots, width)
            np.testing.assert_array_equal(got.numpy(), want)


def test_packed_int_accumulate_wrapper_gates():
    stacked = torch.zeros(2, 8, dtype=torch.uint8)
    before = wire.packed_int_accumulate.launches
    out = wire.packed_int_accumulate(stacked, 16, 4)
    assert out.dtype == torch.uint8 and out.shape == (8,)
    assert wire.packed_int_accumulate.launches == before     # plain on CPU
    with pytest.raises(ValueError, match="width"):
        wire.packed_int_accumulate(stacked, 8, 1)
    with pytest.raises(ValueError, match="uint8"):
        wire.packed_int_accumulate(stacked, 17, 4)            # too few bytes
    with pytest.raises(ValueError, match="uint8"):
        wire.packed_int_accumulate(stacked.to(torch.int8), 16, 4)
    # Slots from numel on come out zero.
    full = torch.full((1, 3), 0xFF, dtype=torch.uint8)
    assert wire.packed_int_accumulate(full, 3, 4).tolist() == [0xFF, 0x0F, 0]


# -- the per-field modular add the kernel rests on ----------------------------

ACCUM_ROW_BYTES = (1, 2, 3, 4, 5, 11, 12, 13, 15, 16, 17, 47, 48, 49, 511,
                   512, 513, 1535, 1536, 1537, 3073)
# The fields' top bits of word g of a row's stream, by g % 3.
TOP_BITS = {2: (0xAAAAAAAA,) * 3, 4: (0x88888888,) * 3,
            3: (0x24924924, 0x49249249, 0x92492492)}
CHUNK_WORDS = 384      # a warp's chunk of the kernel: 1536 bytes
M32 = np.uint64(0xFFFFFFFF)


def _field_sum(stacked, numel, width):
    """The per-field sum of the codes mod ``2^width``: code g is bits
    ``width*g ..`` of each row's little-endian bit stream; the bits from
    ``numel*width`` on come out 0."""
    k, nbytes = stacked.shape
    bits = np.unpackbits(stacked, axis=1, bitorder="little")
    n = numel * width
    codes = bits[:, :n].reshape(k, numel, width).astype(np.int64)
    codes = (codes << np.arange(width)).sum(-1)
    s = codes.sum(0) % (1 << width)
    out = np.zeros(8 * nbytes, np.uint8)
    out[:n] = ((s[:, None] >> np.arange(width)) & 1).reshape(-1)
    return np.packbits(out, bitorder="little")


def _swar_sum(stacked, numel, width, rng):
    """The kernel's arithmetic in numpy: each row as little-endian 32-bit
    words, garbage past its end (the kernel's last 16-byte block reads
    past it), added word by word as ``((a & ~H) + (b & ~H)) ^ ((a ^ b) &
    H)`` with the carry into word g the carry out of word g-1's masked sum
    alone (none at a chunk's first word), then the bits from
    ``numel*width`` on cleared."""
    k, nbytes = stacked.shape
    nwords = -(-nbytes // 16) * 4
    pad = rng.integers(0, 256, (k, 4 * nwords)).astype(np.uint8)
    pad[:, :nbytes] = stacked
    words = pad.view("<u4").astype(np.uint64)
    h = np.array([TOP_BITS[width][g % 3] for g in range(nwords)], np.uint64)
    low = ~h & M32
    acc = words[0]
    for b in words[1:]:
        t = (acc & low) + (b & low)
        carry = t >> np.uint64(32)
        cin = np.concatenate([[np.uint64(0)], carry[:-1]])
        cin[::CHUNK_WORDS] = 0
        acc = (((t & M32) + cin) & M32) ^ ((acc ^ b) & h)
    bit = np.arange(32 * nwords).reshape(nwords, 32)
    keep = ((bit < numel * width) << np.arange(32)).sum(-1).astype(np.uint64)
    return (acc & keep).astype("<u4").view(np.uint8)[:nbytes]


@pytest.mark.parametrize("k", [1, 2, 3, 7, 40])
@pytest.mark.parametrize("width", [2, 3, 4])
def test_packed_int_accumulate_is_a_field_wise_modular_add(width, k):
    """The identity the CUDA kernel rests on: the plain version (unpack,
    sign-extend, add, floored mod, repack) equals the per-field sum of the
    codes mod ``2^width``, and so the kernel's carry-less word add, on
    random bytes whose sums leave the field, over row lengths around the
    word, 3-byte, 16-byte and 1536-byte (a warp's chunk) boundaries, for
    every code slot the bytes hold and for fewer. Past ``ACCUM_ROW_TILE``
    rows the kernel's launches chain through the output."""
    rng = np.random.default_rng(1000 * width + k)
    for nbytes in ACCUM_ROW_BYTES:
        stacked = rng.integers(0, 256, (k, nbytes)).astype(np.uint8)
        slots = nbytes * 8 // width
        for numel in sorted({slots, max(slots - 1, 0), slots // 2}):
            want = wire.packed_int_accumulate_plain(
                torch.from_numpy(stacked), numel, width).numpy()
            np.testing.assert_array_equal(
                _field_sum(stacked, numel, width), want)
            out = None
            for tile in wire.row_tiles(list(stacked), "out"):
                rows = np.stack([out if isinstance(r, str) else r
                                 for r in tile])
                out = _swar_sum(rows, numel, width, rng)
            np.testing.assert_array_equal(out, want)


def test_row_tiles_chain_through_the_output():
    tile = wire.ACCUM_ROW_TILE
    assert wire.row_tiles(list(range(3)), "o") == [[0, 1, 2]]
    assert wire.row_tiles(list(range(tile)), "o") == [list(range(tile))]
    tiles = wire.row_tiles(list(range(40)), "o")
    assert tiles == [list(range(tile)), ["o"] + list(range(tile, 40))]
    tiles = wire.row_tiles(list(range(2 * tile)), "o")
    assert [len(t) for t in tiles] == [tile, tile, 2]
    assert [r for t in tiles for r in t if r != "o"] == list(range(2 * tile))


def _accum_layouts(buf, k, nbytes):
    """``(k, nbytes)`` stacks over the bytes of ``buf`` in the row layouts
    a caller can give the kernel: contiguous (rows off the 16-byte grid
    where nbytes is not a multiple of 16), one extra byte a row, rows
    padded to 16 bytes (``wire.stack_payloads``), a base off the 16-byte
    grid, and rows 17 bytes apart."""
    return {"contiguous": buf[:k * nbytes].view(k, nbytes),
            "extra byte": buf[:k * (nbytes + 1)].view(k, nbytes + 1)[
                :, :nbytes],
            "padded rows": wire.stack_payloads(
                [buf[i * nbytes:(i + 1) * nbytes] for i in range(k)]),
            "unaligned base": buf[1:1 + k * nbytes].view(k, nbytes),
            "stride +17": buf[:k * (nbytes + 17)].view(k, nbytes + 17)[
                :, :nbytes]}


@pytest.mark.parametrize("k", [1, 2, 3, 7])
@pytest.mark.parametrize("width", [2, 3, 4])
def test_packed_int_accumulate_row_layouts_match_pallas(width, k):
    """``packed_int_accumulate`` on rows at any stride (the five layouts)
    and ``packed_int_accumulate_rows`` on separate tensors (the layouts'
    rows, and copies of them) equal the contiguous stack's sum byte for
    byte: on levels bounded to the field, the interpret-mode Pallas
    kernel's too; on random bytes whose sums leave the field, JAX
    homoqsgd's staged accumulate (the Pallas kernel lets such sums carry
    across fields, and at width 3 keeps the bits past the last whole code:
    it is exact only within ``payload_sum_max_world``)."""
    from grace_tpu import compressors as JC
    staged = JC.HomoQSGDCompressor(quantum_num=1, accum_bits=width,
                                   use_pallas=False)
    rng = np.random.default_rng(100 * width + k)
    n = 1001
    nbytes = -(-n * width // 8)               # 126 to 501 bytes: off the grid
    slots = nbytes * 8 // width
    bounded = _pack(_bounded_levels(rng, k, n, width), width).numpy()
    wraps = rng.integers(0, 256, (k, nbytes)).astype(np.uint8)
    for content, want in (
            (bounded, pallas_wire.packed_int_accumulate(
                jnp.asarray(bounded), slots, width, interpret=True)),
            (wraps, staged._packed_accumulate(jnp.asarray(wraps)))):
        want = np.asarray(want)
        np.testing.assert_array_equal(wire.packed_int_accumulate_plain(
            torch.from_numpy(content), slots, width).numpy(), want)
        for layout in ("contiguous", "extra byte", "padded rows",
                       "unaligned base", "stride +17"):
            buf = torch.from_numpy(rng.integers(0, 256, k * (nbytes + 17) + 1)
                                   .astype(np.uint8))
            st = _accum_layouts(buf, k, nbytes)[layout]
            assert st.shape == (k, nbytes) and st.stride(1) == 1, layout
            st.copy_(torch.from_numpy(content))
            for got in (wire.packed_int_accumulate(st, slots, width),
                        wire.packed_int_accumulate_rows(list(st), slots,
                                                        width),
                        wire.packed_int_accumulate_rows(
                            [r.clone() for r in st], slots, width)):
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=layout)


def test_packed_int_accumulate_rows_gates():
    rows = [torch.zeros(8, dtype=torch.uint8) for _ in range(2)]
    before = wire.packed_int_accumulate.launches
    out = wire.packed_int_accumulate_rows(rows, 16, 4)
    assert out.dtype == torch.uint8 and out.shape == (8,)
    assert wire.packed_int_accumulate.launches == before     # plain on CPU
    with pytest.raises(ValueError, match="K >= 1"):
        wire.packed_int_accumulate_rows([], 16, 4)
    with pytest.raises(ValueError, match="equal-length"):
        wire.packed_int_accumulate_rows([rows[0], rows[1][:7]], 14, 4)
    with pytest.raises(ValueError, match="equal-length"):
        wire.packed_int_accumulate_rows([rows[0], rows[1].to(torch.int8)],
                                        16, 4)
    with pytest.raises(ValueError, match="equal-length"):
        wire.packed_int_accumulate_rows([torch.zeros(2, 8, dtype=torch.uint8)],
                                        16, 4)
    with pytest.raises(ValueError, match="width"):
        wire.packed_int_accumulate_rows(rows, 8, 1)
    with pytest.raises(ValueError, match="uint8"):
        wire.packed_int_accumulate_rows(rows, 17, 4)          # too few bytes
