"""The grouped sign-pack of the signSGD vote: many leaves, one launch, with
linear error feedback folded in.

* The grouped plain version (what the CUDA kernel is held to on the card,
  ``chip_smoke.py`` phase 6) against the JAX Pallas ``sign_pack`` in
  interpret mode, leaf by leaf, bit for bit: the sign bytes of each leaf's
  compensated gradient, with and without a residual, at beta, gamma of 1
  and not, over edge lengths and the reduced ResNet's leaf shapes, with
  -0.0, NaN and +-inf planted.
* Each new residual against the port's own staged pipeline
  (``ResidualMemory.compensate`` → ``SignSGDCompressor.compress`` →
  ``ResidualMemory.update``), bit for bit.
* bfloat16 and float16 leaves in pack-only mode, the payload layout (every
  leaf's wire payload a view on a 16-byte boundary of the concatenation,
  padding bits 0), the plan, the constants the CUDA source shares with it,
  and the codec's gates.

The grouped vote over spawned gloo ranks is in
``test_torch_sign_grouped_dist.py``. Inputs are made with numpy from seeds.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grace_tpu.ops import pallas_quant
from grace_tpu_torch.compressors import SignSGDCompressor, SignumCompressor
from grace_tpu_torch.core import LeafKey
from grace_tpu_torch.memories import ResidualMemory
from grace_tpu_torch.ops import quant
from test_torch_chunk_topk import assert_same_bits

EDGE_LENGTHS = [1, 7, 8, 9, 31, 32, 33, 127, 4097]
FEEDBACK = [None, (1.0, 1.0), (0.9, 0.5)]          # None: pack only


def _resnet_shapes():
    from grace_tpu_torch.models.resnet import ResNet
    from grace_tpu_torch.transform import leaf_order
    params = dict(ResNet((1, 1, 0, 0), 10, device="cpu").named_parameters())
    return [tuple(params[n].shape) for n in leaf_order(params)]


# The edge lengths and six reduced-ResNet leaf shapes of distinct sizes
# (a conv kernel, BatchNorm vectors, the head).
SHAPES = [(n,) for n in EDGE_LENGTHS] + list(
    {int(np.prod(s)): s for s in _resnet_shapes()}.values())[:6]


def _leaves(seed=0):
    """float32 gradients and residuals of every shape, -0.0, +0.0, NaN,
    +inf and -inf planted at the head of each gradient and residual."""
    rng = np.random.default_rng(seed)
    edge = np.array([-0.0, 0.0, np.nan, np.inf, -np.inf], np.float32)
    gs, rs = [], []
    for shape in SHAPES:
        g = rng.standard_normal(shape).astype(np.float32)
        r = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        flat = g.reshape(-1)
        flat[:min(flat.size, 5)] = edge[:min(flat.size, 5)]
        r.reshape(-1)[:min(r.size, 4)] = -0.0      # comp[0] is -0.0
        gs.append(g)
        rs.append(r)
    return gs, rs


def _compensated(g, r, feedback):
    """The compensated gradient in numpy float32, each product rounded."""
    if feedback is None:
        return g
    beta, gamma = feedback
    return np.float32(beta) * r + np.float32(gamma) * g


def _grouped(gs, rs, feedback):
    """(payload, each leaf's wire payload view, new residuals)."""
    grads = [torch.from_numpy(g) for g in gs]
    if feedback is None:
        payload, new_rs = quant.sign_pack_grouped(grads)
    else:
        payload, new_rs = quant.sign_pack_grouped(
            grads, [torch.from_numpy(r) for r in rs], *feedback)
    views = quant.sign_plan(tuple(g.size for g in gs)).views(payload)
    return payload, views, new_rs


@pytest.mark.parametrize("feedback", FEEDBACK, ids=["pack_only", "beta1",
                                                    "beta0.9_gamma0.5"])
def test_grouped_sign_bytes_match_pallas_leaf_by_leaf(feedback):
    gs, rs = _leaves(seed=1)
    payload, views, _ = _grouped(gs, rs, feedback)
    assert len(views) == len(gs)
    for g, r, view in zip(gs, rs, views):
        comp = _compensated(g, r, feedback).reshape(-1)
        want = pallas_quant.sign_pack(jnp.asarray(comp), interpret=True)
        np.testing.assert_array_equal(view.numpy(), np.asarray(want))


@pytest.mark.parametrize("feedback", FEEDBACK[1:], ids=["beta1",
                                                        "beta0.9_gamma0.5"])
def test_grouped_residuals_match_the_staged_memory_pipeline(feedback):
    gs, rs = _leaves(seed=2)
    beta, gamma = feedback
    _, views, new_rs = _grouped(gs, rs, feedback)
    mem = ResidualMemory(beta=beta, gamma=gamma)
    codec = SignSGDCompressor(use_pallas=False)
    for g, r, view, new_r in zip(gs, rs, views, new_rs):
        x, state = torch.from_numpy(g), torch.from_numpy(r)
        comp, state = mem.compensate(x, state)
        payload, ctx, _ = codec.compress(comp, None, LeafKey(0, 0, 0))
        want = mem.update(comp, payload, ctx, codec, state)
        np.testing.assert_array_equal(view.numpy(), payload[0].numpy())
        assert new_r.shape == want.shape == g.shape
        assert_same_bits(new_r, want)
    # The head of the first long leaf: comp -0.0 packs 1 and leaves -1,
    # +0.0 leaves -1, NaN packs 0 and stays NaN, +-inf stay +-inf.
    head = new_rs[len(EDGE_LENGTHS) - 1].reshape(-1)[:5].tolist()
    assert head[:2] == [-1.0, -1.0] and np.isnan(head[2])
    assert head[3:] == [np.inf, -np.inf]
    assert views[len(EDGE_LENGTHS) - 1][0].item() & 0b11111 == 0b01011


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_precision_leaves_pack_only_match_pallas(dtype):
    gs, _ = _leaves(seed=3)
    xs = [jnp.asarray(g.reshape(-1)).astype(dtype) for g in gs]
    ts = [torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        getattr(torch, dtype)) for x in xs]
    mixed = [t if i % 2 else t.float() for i, t in enumerate(ts)]
    plan = quant.sign_plan(tuple(t.numel() for t in ts))
    payload, new_rs = quant.sign_pack_grouped(ts)
    views = plan.views(payload)
    mixed_views = plan.views(quant.sign_pack_grouped(mixed)[0])
    assert new_rs is None
    for x, view, mixed_view in zip(xs, views, mixed_views):
        want = np.asarray(pallas_quant.sign_pack(x, interpret=True))
        np.testing.assert_array_equal(view.numpy(), want)
        np.testing.assert_array_equal(mixed_view.numpy(), want)


def test_payload_views_are_aligned_segments_of_one_buffer():
    gs, rs = _leaves(seed=4)
    payload, views, _ = _grouped(gs, rs, (1.0, 1.0))
    plan = quant.sign_plan(tuple(g.size for g in gs))
    assert payload.dtype == torch.uint8 and payload.dim() == 1
    assert payload.numel() == plan.nbytes
    for g, off, view in zip(gs, plan.boff.tolist(), views):
        assert off % quant.SIGN_ALIGN == 0
        assert view.data_ptr() == payload.data_ptr() + off
        assert view.numel() == -(-g.size // 8)
        segment = -(-g.size // 128) * 16           # whole 16-byte groups
        pad = payload[off + view.numel():off + segment]
        assert not pad.any()                       # padding bytes are 0
        tail = g.size % 8
        if tail:                                   # so are padding bits
            assert view[-1].item() >> tail == 0
    assert plan.boff[-1] == sum(-(-g.size // 128) * 16 for g in gs)


@pytest.mark.parametrize("count", [1, 161, 600])
def test_sign_plan_tiles_every_word_once(count):
    ns = tuple(int(n) for n in np.random.default_rng(count).integers(
        1, 40_000, count))
    plan = quant.sign_plan(ns)
    assert quant.sign_plan(ns) is plan                      # cached
    assert len(plan.launches) == -(-count // quant.MAX_LEAVES_PER_LAUNCH)
    assert all(hi - lo <= quant.MAX_LEAVES_PER_LAUNCH
               for lo, hi in plan.launches)
    for lo, hi in plan.launches:
        table = plan.table(lo, hi)
        np.testing.assert_array_equal(table[:, 3], ns[lo:hi])
        np.testing.assert_array_equal(table[:, 5], plan.boff[lo:hi])
        assert (table[:, 5] % 16 == 0).all()
        words = (table[:, 3] + 127) // 128 * 4
        tiles = -(-words // quant.SIGN_TILE_WORDS)
        # The tile prefix the kernel searches, from the launch's first leaf.
        np.testing.assert_array_equal(table[:, 6],
                                      np.cumsum(tiles) - tiles)
    np.testing.assert_array_equal(
        np.diff(plan.boff), [-(-n // 128) * 16 for n in ns])


def test_sign_constants_match_the_cuda_source():
    from grace_tpu_torch.ops import _build
    text = _build.sources()["quant"].read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kMaxLeaves") == quant.MAX_LEAVES_PER_LAUNCH
    threads, warp_words = const("kThreads"), const("kSignWarpWords")
    assert threads // 32 * warp_words == quant.SIGN_TILE_WORDS
    assert const("kSignWords") == quant.sign_plan((5,)).table(0, 1).shape[1]
    assert "__grid_constant__" in text


def test_grouped_wrapper_takes_the_plain_version_only_on_cpu():
    gs, rs = _leaves(seed=5)
    before = quant.launch_counts()
    _grouped(gs, rs, (1.0, 1.0))
    _grouped(gs, rs, None)
    assert quant.launch_counts() == before                  # no kernel ran
    with pytest.raises(ValueError, match="no sign_pack_grouped"):
        quant.sign_pack_grouped([torch.zeros(3, device="meta")])
    with pytest.raises(ValueError, match="sign_pack takes"):
        quant.sign_pack_grouped([torch.zeros(3, dtype=torch.float64)])
    with pytest.raises(ValueError, match="at least one element"):
        quant.sign_plan((4, 0))


def test_one_leaf_sign_pack_is_the_grouped_one_leaf_case():
    gs, _ = _leaves(seed=6)
    for g in gs:
        x = torch.from_numpy(g.reshape(-1))
        payload, _ = quant.sign_pack_grouped([x])
        (view,) = quant.sign_plan((x.numel(),)).views(payload)
        np.testing.assert_array_equal(quant.sign_pack(x).numpy(),
                                      view.numpy())


def test_codec_gates_read_shapes_and_dtypes():
    codec = SignSGDCompressor()
    xs = [torch.ones(10), torch.ones(4, dtype=torch.float16),
          torch.ones(6, 4).t(), torch.ones(3), torch.ones(5)]
    states = [torch.zeros(10), torch.zeros(4), torch.zeros(4, 6),
              torch.zeros(3, dtype=torch.bfloat16), torch.zeros(5)]
    rngs = [LeafKey(0, 0, i) for i in range(len(xs))]
    taken, (payload,), ctx, new = codec.fused_feedback_compress_leaves(
        xs, states, (1.0, 1.0), rngs)
    # float16, transposed and bfloat16-state leaves take the per-leaf path.
    assert taken == [0, 4] and len(new) == 2
    assert payload.numel() == quant.sign_plan((10, 5)).nbytes
    decoded = codec.decompress_leaves((payload,), ctx)
    outs = codec.leaf_views(decoded, ctx)
    assert [tuple(o.shape) for o in outs] == [(10,), (5,)]
    assert all((o == 1).all() for o in outs)               # 1 + 0 >= 0
    # No memory: only leaves without state.
    taken, _, _, new = codec.fused_feedback_compress_leaves(
        xs, [None, None, None, torch.zeros(3), None], None, rngs)
    assert taken == [0, 4] and new == [None, None]
    assert SignSGDCompressor(use_pallas=False).fused_feedback_compress_leaves(
        xs, states, (1.0, 1.0), rngs) is None
    assert SignumCompressor().fused_feedback_compress_leaves is None
