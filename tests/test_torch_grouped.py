"""The grouped chunk Top-K path: many leaves, one launch of each kernel.

* The grouped plain versions against the JAX Pallas kernels (interpret
  mode), leaf by leaf, bit for bit: compress over a mixed leaf table, the
  aggregate at W = 1, 3 and 8 with colliding and out-of-range rows.
* The leaf plan: every column of every leaf in exactly one tile of one
  launch, the K- and N-offsets tiling their totals, and the constants the
  CUDA source shares with it.

The transform's grouped path over spawned gloo ranks is in
``test_torch_grouped_dist.py``.

Inputs are made with numpy from seeds. On the CPU the wrappers run the plain
versions, which the CUDA kernels are held to on the card (chip_smoke.py
phase 2).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grace_tpu.ops import pallas_topk
from grace_tpu_torch.compressors import static_k
from grace_tpu_torch.ops import chunk_topk as ck
from test_torch_chunk_topk import _inputs, assert_same_bits

# (n, k, residual, edge columns): k = 1, tail rows, the edge-column leaf,
# a leaf without residual, a 4-row leaf and a many-tile leaf.
LEAVES = [
    (1000, 10, True, True),
    (64, 1, True, False),
    (9408, 94, True, False),          # ResNet-50 stem: 100 rows + a tail
    (1003, 13, False, False),         # residual=None
    (257, 10, True, False),
    (4096, 1024, True, False),
    (36864, 368, True, False),
]


def _leaf_inputs():
    gs, rs = [], []
    for i, (n, k, has_r, edge) in enumerate(LEAVES):
        g, r = _inputs(n, seed=i, edge=edge, k=k)
        gs.append(g)
        rs.append(r if has_r else None)
    return gs, rs


@pytest.mark.parametrize("beta,gamma,bf16", [
    (1.0, 1.0, False), (0.9, 0.5, False), (1.0, 1.0, True),
    (0.9, 0.5, True)])
def test_grouped_compress_matches_pallas_leaf_by_leaf(beta, gamma, bf16):
    gs, rs = _leaf_inputs()
    ks = [k for _, k, _, _ in LEAVES]
    vals, idx, resids = ck.chunk_compress_feedback_grouped(
        [torch.from_numpy(g) for g in gs],
        [None if r is None else torch.from_numpy(r) for r in rs], ks,
        beta=beta, gamma=gamma, wire_bf16=bf16)
    assert vals.shape == idx.shape == (sum(ks),)
    assert vals.dtype == (torch.bfloat16 if bf16 else torch.float32)
    off = 0
    for g, r, k, new_r in zip(gs, rs, ks, resids):
        want_v, want_w, want_r = pallas_topk.chunk_compress_feedback(
            jnp.asarray(g), None if r is None else jnp.asarray(r), k,
            beta=beta, gamma=gamma, wire_bf16=bf16, interpret=True)
        assert_same_bits(vals[off:off + k], want_v)
        want_idx = np.asarray(want_w) * k + np.arange(k, dtype=np.int32)
        assert_same_bits(idx[off:off + k], want_idx)
        assert_same_bits(new_r, want_r)
        off += k


def test_grouped_compress_edge_leaf_inside_a_group():
    gs, rs = _leaf_inputs()
    ks = [k for _, k, _, _ in LEAVES]
    vals, idx, _ = ck.chunk_compress_feedback_grouped(
        [torch.from_numpy(g) for g in gs],
        [None if r is None else torch.from_numpy(r) for r in rs], ks)
    # The edge-column leaf comes first, at K-offset 0 with k = 10.
    assert idx[7] == 7 and idx[3] == 3 and idx[1] == 1      # row 0 wins
    assert vals[5].view(torch.int32) == 0                   # +0.0 ships


@pytest.mark.parametrize("world", [1, 3, 8])
@pytest.mark.parametrize("average", [True, False])
def test_grouped_aggregate_matches_pallas_leaf_by_leaf(world, average):
    bf16 = world == 3
    rng = np.random.default_rng(world)
    ks = [k for _, k, _, _ in LEAVES]
    ns = [n for n, _, _, _ in LEAVES]
    vals, wins = [], []
    for n, k in zip(ns, ks):
        xs = rng.standard_normal((world, n)).astype(np.float32)
        pays = [ck.chunk_compress_feedback_plain(torch.from_numpy(x), None, k,
                                                 wire_bf16=bf16) for x in xs]
        v = torch.stack([p[0] for p in pays])
        w = torch.stack([p[1] for p in pays])
        w[0] = w[world - 1]                     # colliding rows across ranks
        w[world // 2, k // 2] = n // k + 5      # out of range: dropped
        vals.append(v)
        wins.append(w)
    idx = torch.cat([w * k + torch.arange(k, dtype=torch.int32)
                     for w, k in zip(wins, ks)], dim=1)
    out = ck.chunk_aggregate_dense_grouped(torch.cat(vals, dim=1), idx, ks,
                                           ns, average=average)
    assert out.shape == (sum(ns),) and out.dtype == torch.float32
    off = 0
    for v, w, k, n in zip(vals, wins, ks, ns):
        want = pallas_topk.chunk_aggregate_dense(
            jnp.asarray(v.float().numpy()), jnp.asarray(w.numpy()), k, n,
            average=average, interpret=True)
        assert_same_bits(out[off:off + n], want)
        off += n


@pytest.mark.parametrize("average", [True, False])
def test_grouped_aggregate_at_a_thousand_ranks_matches_pallas(average):
    # Past the CUDA kernel's 840-rank tile: the partial sums carry from one
    # rank tile to the next, in rank order. Rows are drawn over every real
    # row, the tail row and one past it, so that many ranks collide.
    world = 1000
    leaves = [(64, 4), (300, 7)]
    rng = np.random.default_rng(7)
    ks = [k for _, k in leaves]
    ns = [n for n, _ in leaves]
    vals = rng.standard_normal((world, sum(ks))).astype(np.float32)
    wins = [rng.integers(0, n // k + 2, (world, k)).astype(np.int32)
            for n, k in leaves]
    idx = np.concatenate([w * k + np.arange(k, dtype=np.int32)
                          for w, k in zip(wins, ks)], axis=1)
    out = ck.chunk_aggregate_dense_grouped(torch.from_numpy(vals),
                                           torch.from_numpy(idx), ks, ns,
                                           average=average)
    koff = noff = 0
    for (n, k), w in zip(leaves, wins):
        v = vals[:, koff:koff + k]
        # The Pallas kernel reads the tail row as win == n // k; its caller
        # never sends a row past it, so those are dropped here first.
        v = np.where(w <= n // k, v, np.float32(0.0))
        want = pallas_topk.chunk_aggregate_dense(
            jnp.asarray(v), jnp.asarray(np.minimum(w, n // k)), k, n,
            average=average, interpret=True)
        assert_same_bits(out[noff:noff + n], want)
        koff += k
        noff += n


def _random_sizes(count, seed):
    rng = np.random.default_rng(seed)
    ns = rng.integers(2, 40_000, count)
    ks = [static_k(int(n), float(r)) for n, r in
          zip(ns, rng.choice([0.001, 0.01, 0.1, 0.5], count))]
    return tuple(ks), tuple(int(n) for n in ns)


@pytest.mark.parametrize("count,seed", [(1, 0), (161, 1), (600, 2)])
def test_leaf_plan_covers_every_column_once(count, seed):
    ks, ns = _random_sizes(count, seed)
    plan = ck.leaf_plan(ks, ns)
    assert ck.leaf_plan(ks, ns) is plan                     # cached
    assert plan.k_total == sum(ks) and plan.n_total == sum(ns)
    np.testing.assert_array_equal(np.diff(plan.koff), ks)
    np.testing.assert_array_equal(np.diff(plan.noff), ns)
    assert plan.koff[0] == 0 and plan.noff[0] == 0
    spans = [hi - lo for lo, hi in plan.launches]
    assert plan.launches[0][0] == 0 and plan.launches[-1][1] == count
    assert all(a[1] == b[0] for a, b in zip(plan.launches, plan.launches[1:]))
    assert max(spans) <= ck.MAX_LEAVES_PER_LAUNCH
    assert len(plan.launches) == -(-count // ck.MAX_LEAVES_PER_LAUNCH)
    hits = [np.zeros(k, dtype=np.int64) for k in ks]
    for lo, hi in plan.launches:
        table = plan.table(lo, hi, 3)
        np.testing.assert_array_equal(table[:, 3], ns[lo:hi])
        np.testing.assert_array_equal(table[:, 4], ks[lo:hi])
        np.testing.assert_array_equal(table[:, 5], plan.koff[lo:hi])
        tile0 = np.append(table[:, 6], plan.tile0[hi] - plan.tile0[lo])
        assert tile0[0] == 0
        tiles = np.arange(tile0[-1])
        # The kernel's search: the last leaf whose first tile <= the tile.
        leaf = np.searchsorted(tile0[:-1], tiles, side="right") - 1
        for t, l in zip(tiles, leaf):
            cols = (t - tile0[l]) * ck.TILE_COLS + np.arange(ck.TILE_COLS)
            cols = cols[cols < ks[lo + l]]
            assert cols.size                    # no tile without a column
            hits[lo + l][cols] += 1
    assert all((h == 1).all() for h in hits)


def test_grouped_constants_match_the_cuda_source():
    from grace_tpu_torch.ops import _build
    text = _build.sources()["chunk_topk"].read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kTileCols") == ck.TILE_COLS
    assert const("kMaxLeaves") == ck.MAX_LEAVES_PER_LAUNCH
    plan = ck.leaf_plan((3,), (9,))
    assert const("kCompressWords") == plan.table(0, 1, 3).shape[1]
    assert const("kAggregateWords") == plan.table(0, 1, 1).shape[1]
    assert "__grid_constant__" in text


def test_grouped_wrappers_take_plain_versions_only_on_cpu():
    gs, rs = _leaf_inputs()
    ks = [k for _, k, _, _ in LEAVES]
    before = ck.launch_counts()
    vals, idx, _ = ck.chunk_compress_feedback_grouped(
        [torch.from_numpy(g) for g in gs],
        [None if r is None else torch.from_numpy(r) for r in rs], ks)
    ck.chunk_aggregate_dense_grouped(vals[None], idx[None], ks,
                                     [n for n, _, _, _ in LEAVES])
    assert ck.launch_counts() == before                     # no kernel ran
    with pytest.raises(ValueError, match="no chunk_compress_feedback"):
        ck.chunk_compress_feedback_grouped(
            [torch.from_numpy(gs[0]).to("meta")], [None], [ks[0]])
    with pytest.raises(ValueError, match="no chunk_aggregate_dense"):
        ck.chunk_aggregate_dense_grouped(vals[None].to("meta"),
                                         idx[None].to("meta"), ks,
                                         [n for n, _, _, _ in LEAVES])
    with pytest.raises(ValueError, match="K="):
        ck.chunk_aggregate_dense_grouped(vals[None, 1:], idx[None, 1:], ks,
                                         [n for n, _, _, _ in LEAVES])
