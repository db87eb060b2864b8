"""The port's chunk Top-K kernels (plain versions) against the JAX Pallas
kernels in interpret mode, bit for bit.

Inputs are made with numpy from a seed and handed to both packages. On the
CPU the port's wrappers run the plain versions, which is what the CUDA
kernels are held to on the card (chip_smoke.py phase 2). Bit patterns are
compared (int views), so -0.0 and +0.0 differ; NaNs are compared by
position, since the two packages need not produce the same NaN payload.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grace_tpu.ops import pallas_topk
from grace_tpu_torch.compressors import static_k
from grace_tpu_torch.ops import chunk_topk as ck

_INT_VIEW = {np.dtype(np.float32): np.int32, np.dtype(np.int32): np.int32}


def _np(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(t)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a


def assert_same_bits(port, ref):
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape and p.dtype == r.dtype, (p.dtype, r.dtype)
    if p.dtype == np.float32:
        nan_p, nan_r = np.isnan(p), np.isnan(r)
        np.testing.assert_array_equal(nan_p, nan_r)
        p, r = np.where(nan_p, 0, p.view(np.int32)), np.where(nan_r, 0, r.view(np.int32))
    np.testing.assert_array_equal(p, r)


def _inputs(n, seed=0, edge=False, k=None):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32)
    r = (rng.standard_normal(n) * 0.1).astype(np.float32)
    if edge:
        # NaN in column 7, all -0.0 column 5 (its winner ships as +0.0),
        # all-zero column 3, tied column 1 (the first row wins).
        g[437] = np.nan
        g[5::k] = -0.0
        r[5::k] = -0.0
        g[3::k] = 0.0
        r[3::k] = 0.0
        g[1::k] = 2.0
        r[1::k] = 0.0
    return g, r


COMPRESS_CASES = [
    # (n, ratio, residual, beta, gamma, wire_bf16)
    (1000, 0.01, True, 1.0, 1.0, False),
    (1003, 0.013, True, 1.0, 1.0, False),
    (257, 0.04, True, 1.0, 1.0, False),
    (9408, 0.01, True, 1.0, 1.0, False),     # ResNet-50 stem, tail row
    (64, 0.01, True, 1.0, 1.0, False),       # BN leaf: k=1, 64 rows
    (1003, 0.013, False, 1.0, 1.0, False),   # residual=None
    (1003, 0.013, True, 0.9, 0.5, False),    # feedback coefficients
    (1003, 0.013, False, 0.9, 0.5, False),
    (1003, 0.013, True, 1.0, 1.0, True),     # bf16 wire
    (4096, 0.25, True, 0.9, 0.5, True),
]


@pytest.mark.parametrize("n,ratio,has_r,beta,gamma,bf16", COMPRESS_CASES)
def test_compress_matches_pallas_interpret(n, ratio, has_r, beta, gamma, bf16):
    k = static_k(n, ratio)
    g, r = _inputs(n)
    want = pallas_topk.chunk_compress_feedback(
        jnp.asarray(g), jnp.asarray(r) if has_r else None, k, beta=beta,
        gamma=gamma, wire_bf16=bf16, interpret=True)
    got = ck.chunk_compress_feedback(
        torch.from_numpy(g), torch.from_numpy(r) if has_r else None, k,
        beta=beta, gamma=gamma, wire_bf16=bf16)
    for w, o in zip(want, got):
        assert_same_bits(o, w)


@pytest.mark.parametrize("has_r,beta,gamma,bf16", [
    (True, 1.0, 1.0, False), (False, 1.0, 1.0, False),
    (True, 0.9, 0.5, True)])
def test_compress_edge_columns_match_pallas(has_r, beta, gamma, bf16):
    n, k = 1000, 10
    g, r = _inputs(n, edge=True, k=k)
    want = pallas_topk.chunk_compress_feedback(
        jnp.asarray(g), jnp.asarray(r) if has_r else None, k, beta=beta,
        gamma=gamma, wire_bf16=bf16, interpret=True)
    vals, win, resid = ck.chunk_compress_feedback(
        torch.from_numpy(g), torch.from_numpy(r) if has_r else None, k,
        beta=beta, gamma=gamma, wire_bf16=bf16)
    for w, o in zip(want, (vals, win, resid)):
        assert_same_bits(o, w)
    assert win[7] == 0 and win[3] == 0 and win[1] == 0
    assert vals[5].float().view(torch.int32) == 0          # +0.0, not -0.0
    assert np.isnan(resid.numpy()).any()                   # NaN stays visible


@pytest.mark.parametrize("world,n,ratio,bf16", [
    (1, 1000, 0.01, False), (8, 1003, 0.013, False), (8, 4096, 0.25, True),
    (40, 1000, 0.01, False)])
@pytest.mark.parametrize("average", [True, False])
def test_aggregate_matches_pallas_interpret(world, n, ratio, bf16, average):
    k = static_k(n, ratio)
    rng = np.random.default_rng(world)
    xs = rng.standard_normal((world, n)).astype(np.float32)
    pays = [ck.chunk_compress_feedback_plain(torch.from_numpy(x), None, k,
                                             wire_bf16=bf16) for x in xs]
    vals = torch.stack([p[0] for p in pays])
    win = torch.stack([p[1] for p in pays])
    win[0] = win[world - 1]                 # colliding rows across ranks
    vals_j = jnp.asarray(vals.float().numpy())
    want = pallas_topk.chunk_aggregate_dense(
        vals_j, jnp.asarray(win.numpy()), k, n, average=average,
        interpret=True)
    got = ck.chunk_aggregate_dense(vals, win, k, n, average=average)
    assert_same_bits(got, want)


def test_wrapper_takes_plain_version_only_on_cpu():
    n, k = 1000, 10
    g, r = _inputs(n)
    before = (ck.chunk_compress_feedback.launches,
              ck.chunk_aggregate_dense.launches)
    vals, win, _ = ck.chunk_compress_feedback(torch.from_numpy(g),
                                              torch.from_numpy(r), k)
    ck.chunk_aggregate_dense(vals[None], win[None], k, n)
    # No kernel ran, so no launch was counted.
    assert (ck.chunk_compress_feedback.launches,
            ck.chunk_aggregate_dense.launches) == before
    with pytest.raises(ValueError):
        ck.chunk_compress_feedback(torch.from_numpy(g), None, 600)   # n < 2k
    with pytest.raises(ValueError):
        ck.chunk_compress_feedback(torch.from_numpy(g).double(), None, k)
    with pytest.raises(ValueError):
        ck.chunk_compress_feedback(torch.from_numpy(g).to("meta"), None, k)


def test_kernel_source_and_build_are_found_without_building():
    from grace_tpu_torch.ops import _build
    srcs = _build.sources()
    assert set(srcs) == {"chunk_topk", "quant", "wire"}
    text = srcs["chunk_topk"].read_text()
    for sym in ("grace_chunk_compress_feedback", "grace_chunk_aggregate_dense",
                "__fmul_rn", "__fadd_rn", "__fdiv_rn"):
        assert sym in text
    # The library name is keyed by the source and flags.
    assert _build._target(srcs["chunk_topk"]).name.startswith("libchunk_topk-")
