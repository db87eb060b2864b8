"""The rest of GRACE's codec catalog in the port, against the JAX package's
codecs and memories on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX codecs run jitted, as the transform runs them: XLA contracts some
multiply-adds into FMAs and turns divisions by constants into reciprocal
multiplies, and the port follows the jitted rounding.

* Bit for bit, payload and decompressed tensor, where the codec sums no
  floats: natural, inceptionn, u8bit, threshold, cyclic Top-K, DGC (its
  threshold is a count and its selection a Top-K), the sketch (its
  quantiles written out as XLA rounds them; its per-bin sums add in
  element order on both sides here) and ``approx`` Top-K.
* Within a stated tolerance where the codec sums floats: TernGrad (the
  standard deviation), 1-bit (the two sums of each side), EF-SignSGD (the
  mean |x|), AdaQ (each side's mean), PowerSGD (matmuls and QRs); their
  integer parts (codes, masks, indices) bit for bit.
* Top-K-based codecs order ties otherwise than ``lax.top_k``; the inputs
  have no ties in |x| (checked), and sparse payloads are compared as
  (index, value) sets.
* The stochastic codecs get JAX's draws through :class:`JaxKey`.

Also: each memory against JAX's ``compensate``/``update``; the helper's
names and defaults; the catalog-wide payload-shape and degenerate-input
checks of the JAX package's ``tests/test_compressors.py``; and the byte
models of every new codec.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grace_tpu import compressors as JC
from grace_tpu import memories as JM

from grace_tpu_torch import compressors as C
from grace_tpu_torch import grace_from_params
from grace_tpu_torch import memories as M
from grace_tpu_torch.core import LeafKey


# -- JAX's draws through the port's key ---------------------------------------

def jax_key_of(key: LeafKey):
    """The JAX key of a port key: ``fold_in(fold_in(key(seed), count),
    leaf)``, then each fold (``('split', i)`` is ``split(k)[i]``)."""
    k = jax.random.fold_in(jax.random.fold_in(jax.random.key(key.seed),
                                              key.count), key.leaf)
    for f in key.folds:
        k = jax.random.split(k)[f[1]] if isinstance(f, tuple) else \
            jax.random.fold_in(k, f)
    return k


@dataclasses.dataclass(frozen=True)
class JaxKey(LeafKey):
    """A key whose draws are JAX's under :func:`jax_key_of`. Spawned
    workers use it too (they import JAX for it), patched into the
    transform in place of ``LeafKey``."""

    def split(self):
        return tuple(dataclasses.replace(self, folds=self.folds
                                         + (("split", i),)) for i in (0, 1))

    def uniform(self, shape, device):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax_key_of(self), tuple(shape)))).to(device)

    def randint(self, shape, low, high, device):
        return torch.from_numpy(np.array(jax.random.randint(
            jax_key_of(self), tuple(shape), low, high,
            dtype=jnp.int32))).to(device)

    def normal(self, shape, device):
        return torch.from_numpy(np.array(jax.random.normal(
            jax_key_of(self), tuple(shape)))).to(device)

    def permutation(self, n, device):
        return torch.from_numpy(np.array(jax.random.permutation(
            jax_key_of(self), n))).long().to(device)


# -- inputs and comparisons ---------------------------------------------------

SHAPES = [(1000,), (3, 3, 16, 8), (40, 25)]


def inputs(shape, seed=3):
    """Normals at scale 0.8, every 7th tripled (some past 1.0, for
    inceptionn's overflow lane), with distinct magnitudes."""
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.8).astype(
        np.float32)
    x.reshape(-1)[::7] *= 3.0
    assert np.unique(np.abs(x)).size == x.size          # no ties in |x|
    return x


def as_np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def same_bits(a, b):
    a, b = as_np(a), as_np(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
    np.testing.assert_array_equal(a.view(f"u{a.dtype.itemsize}"),
                                  b.view(f"u{b.dtype.itemsize}"))


def sparse_pairs(values, indices):
    v, i = as_np(values), as_np(indices).astype(np.int64)
    order = np.argsort(i)
    return i[order], v[order]


def run_jax(codec, x, key):
    """JAX ``compress`` jitted (payload) and eager (ctx), and its jitted
    decompress."""
    jx = jnp.asarray(x)
    jk = jax_key_of(key)
    payload = jax.jit(lambda a, k: codec.compress(a, None, k)[0])(jx, jk)
    _, ctx, _ = codec.compress(jx, None, jk)
    return payload, ctx, codec.decompress(payload, ctx)


def run_port(codec, x, key):
    payload, ctx, _ = codec.compress(torch.from_numpy(x.copy()), None, key)
    return payload, ctx, codec.decompress(payload, ctx)


KEY = JaxKey(0, 2, 5)

# name: (port codec, JAX codec, payload positions of (values, indices)
# pairs compared as sets; other positions compared bit for bit)
EXACT = {
    "natural": (C.NaturalCompressor(), JC.NaturalCompressor(), ()),
    "inceptionn": (C.InceptionNCompressor(), JC.InceptionNCompressor(),
                   ((1, 2),)),
    "u8bit": (C.U8bitCompressor(), JC.U8bitCompressor(), ()),
    "threshold": (C.ThresholdCompressor(threshold=0.5, capacity_ratio=0.3),
                  JC.ThresholdCompressor(threshold=0.5, capacity_ratio=0.3),
                  ((0, 1),)),
    "threshold_default": (C.ThresholdCompressor(), JC.ThresholdCompressor(),
                          ((0, 1),)),
    "cyclictopk": (C.CyclicTopKCompressor(0.1), JC.CyclicTopKCompressor(0.1),
                   ()),
    "cyclictopk_1pct": (C.CyclicTopKCompressor(), JC.CyclicTopKCompressor(),
                        ()),
    "dgc": (C.DgcCompressor(0.3), JC.DgcCompressor(0.3), ((0, 1),)),
    "dgc_1pct": (C.DgcCompressor(), JC.DgcCompressor(), ((0, 1),)),
    "sketch64": (C.SketchCompressor(64), JC.SketchCompressor(64), ()),
    "sketch300": (C.SketchCompressor(300), JC.SketchCompressor(300), ()),
    "topk_approx": (C.TopKCompressor(0.01, "approx"),
                    JC.TopKCompressor(0.01, "approx"), ()),
}


def _check_payload(pp, jp, pairs):
    assert len(pp) == len(jp)
    paired = {p for pair in pairs for p in pair}
    for vi, ii in pairs:
        pi, pv = sparse_pairs(pp[vi], pp[ii])
        ji, jv = sparse_pairs(jp[vi], jp[ii])
        np.testing.assert_array_equal(pi, ji)
        same_bits(pv, jv)
        assert pp[ii].dtype == torch.int32
    for pos, (a, b) in enumerate(zip(pp, jp)):
        if pos not in paired:
            same_bits(a, b)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", sorted(EXACT))
def test_codec_matches_jax_bit_for_bit(name, shape):
    port, ref, pairs = EXACT[name]
    x = inputs(shape)
    pp, pctx, pd = run_port(port, x, KEY)
    jp, _, jd = run_jax(ref, x, KEY)
    _check_payload(pp, jp, pairs)
    assert tuple(pd.shape) == shape and pd.dtype == torch.float32
    same_bits(pd, jd)


def test_dgc_selection_given_the_threshold():
    """DGC's refined threshold selects what JAX's does: JAX's nonzero
    lanes are exactly the capacity's largest |x| at or above the port's
    threshold. And the masked refinement rounds equal the early-exit loop:
    past the band, a round changes nothing."""
    from grace_tpu_torch.compressors.dgc import refine_threshold
    x = inputs((3, 3, 16, 8))
    mags = np.abs(x).reshape(-1)
    for ratio in (0.01, 0.05, 0.3):
        port = C.DgcCompressor(ratio)
        thr = port.threshold(torch.from_numpy(mags), KEY).item()
        jp, _, _ = run_jax(JC.DgcCompressor(ratio), x, KEY)
        idx, vals = sparse_pairs(jp[0], jp[1])
        cap = np.asarray(jp[1]).size
        top = np.argsort(-mags)[:cap]
        np.testing.assert_array_equal(idx[vals != 0],
                                      np.sort(top[mags[top] >= thr]))
    seq = []

    def count(t):
        seq.append(float(t))
        return torch.tensor(100.0 if float(t) < 1.0 else 30.0)

    thr, sel = refine_threshold(torch.tensor(0.5), count, 10,
                                lambda s: s > 50, lambda s: s < 20, 1.3, 0.7)
    # 0.5 -> 0.65 -> 0.845 -> 1.0985 (in the band); the later rounds hold.
    want = np.float32(0.5)
    for _ in range(3):
        want = want * np.float32(1.3)
    assert np.float32(thr.item()) == want
    assert sel.item() == 30.0
    assert len(seq) == 11


# name: (port codec, JAX codec, float payload positions and their
# reduction, rtol)
TOLERANT = {
    # std over the leaf; the scale is the clipped max (= 2.5·std when
    # anything is clipped).
    "terngrad": (C.TernGradCompressor(), JC.TernGradCompressor(), (1,),
                 2e-6),
    # each side's sum over the leaf, divided by its count.
    "onebit": (C.OneBitCompressor(), JC.OneBitCompressor(), (1, 2), 2e-6),
    # the mean |x| over the leaf.
    "efsignsgd": (C.EFSignSGDCompressor(), JC.EFSignSGDCompressor(), (0,),
                  2e-6),
    # each side's mean over its selected entries.
    "adaq": (C.AdaqCompressor(0.3), JC.AdaqCompressor(0.3), (0, 3), 2e-6),
    "adaq_1pct": (C.AdaqCompressor(), JC.AdaqCompressor(), (0, 3), 2e-6),
}


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", sorted(TOLERANT))
def test_codec_matches_jax_within_its_reduction(name, shape):
    """Float sums in another order: the float payload entries and the
    decompressed tensor agree within ``rtol`` (a few float32 ulps); every
    integer entry (codes, masks, indices, validity bits) bit for bit."""
    port, ref, floats, rtol = TOLERANT[name]
    x = inputs(shape)
    pp, _, pd = run_port(port, x, KEY)
    jp, _, jd = run_jax(ref, x, KEY)
    assert len(pp) == len(jp)
    for pos, (a, b) in enumerate(zip(pp, jp)):
        if pos in floats:
            np.testing.assert_allclose(as_np(a), as_np(b), rtol=rtol)
        else:
            same_bits(a, b)
    assert tuple(pd.shape) == shape
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=rtol,
                               atol=0)


def test_efsignsgd_aggregate_is_the_jitted_division():
    x = np.random.default_rng(5).standard_normal((3, 500)).astype(np.float32)
    for lr in (0.1, 0.3, 0.01):
        got = C.EFSignSGDCompressor(lr=lr).aggregate(torch.from_numpy(x))
        want = jax.jit(JC.EFSignSGDCompressor(lr=lr).aggregate)(
            jnp.asarray(x))
        same_bits(got, want)


def test_terngrad_draws_jax_uniforms_scaled_bit_for_bit():
    """``uniform · max(scale, 1e-30)`` is JAX's ``uniform(maxval=...)`` bit
    for bit, so the codes agree wherever the scale does."""
    shape = (4096,)
    for scale in (3.7, 1e-31, 0.0123):
        got = KEY.uniform(shape, "cpu") * torch.clamp_min(
            torch.tensor(scale, dtype=torch.float32), 1e-30)
        want = jax.jit(lambda k, m: jax.random.uniform(
            k, shape, jnp.float32, maxval=jnp.maximum(m, 1e-30)))(
            jax_key_of(KEY), jnp.float32(scale))
        same_bits(got, want)


def test_quantile_past_two_to_the_24_matches_jax():
    """``torch.quantile`` refuses more than 2^24 elements; the sketch's
    own quantile equals ``jnp.quantile`` there too, past the float32
    rounding of ``n − 1``."""
    from grace_tpu_torch.compressors.sketch import quantile_linear
    x = np.random.default_rng(0).standard_normal(2**24 + 5).astype(
        np.float32)
    for bins in (64, 300):
        q = C.SketchCompressor(bins).quantile_points("cpu")
        got = quantile_linear(torch.from_numpy(x), q)
        want = jax.jit(lambda a: jnp.quantile(
            a, jnp.linspace(0.0, 1.0, bins + 1)))(jnp.asarray(x))
        same_bits(got, want)
    assert torch.isnan(quantile_linear(torch.tensor([1.0, float("nan")]),
                                       torch.tensor([0.0, 0.5]))).all()


def test_sketch_ids_travel_as_uint16_above_256_bins():
    x = inputs((1000,))
    (ids, _), _, _ = run_port(C.SketchCompressor(300), x, KEY)
    assert ids.dtype == torch.uint16
    assert run_port(C.SketchCompressor(256), x, KEY)[0][0].dtype == \
        torch.uint8


def test_threshold_calibrated_matches_jax():
    x = inputs((40, 25))
    for thr in (0.01, 0.5, 2.0):
        got = C.ThresholdCompressor(threshold=thr).calibrated(
            torch.from_numpy(x))
        want = JC.ThresholdCompressor(threshold=thr).calibrated(
            jnp.asarray(x))
        assert got.capacity_ratio == pytest.approx(want.capacity_ratio,
                                                   rel=1e-6)


# -- approx Top-K --------------------------------------------------------------

@pytest.mark.parametrize("numel,ratio", [(10_000, 0.01), (1000, 0.3),
                                         (2048, 0.2), (257, 0.04)])
def test_approx_topk_equals_jax_approx_on_the_cpu(numel, ratio):
    """Off the TPU ``lax.approx_max_k`` is an exact sort whatever the
    recall target: the port's exact selection is JAX's ``approx`` bit for
    bit, on both sides of the ``n > 4k`` branch."""
    x = inputs((numel,), seed=9)
    for recall in (0.95, 0.5):
        port = grace_from_params({"compressor": "topk",
                                  "compress_ratio": ratio,
                                  "topk_algorithm": "approx",
                                  "recall_target": recall}).compressor
        assert (port.algorithm, port.recall_target) == ("approx", recall)
        ref = JC.TopKCompressor(ratio, "approx", recall_target=recall)
        pp, _, pd = run_port(port, x, KEY)
        jp, _, jd = run_jax(ref, x, KEY)
        same_bits(pp[0], jp[0])
        same_bits(pp[1], jp[1])
        same_bits(pd, jd)


# -- PowerSGD in a one-rank group ------------------------------------------------

@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


def _jax_one_device(fn, *args):
    from jax.sharding import Mesh, PartitionSpec as P

    from grace_tpu.parallel import shard_map
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(),
                             check_vma=False))(*args)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("rank", [1, 2, 4])
def test_powersgd_matches_jax_at_one_rank(group, rank, shape):
    """The initial Q (threefry, within a few ulps of JAX's draw), the two
    QRs and matmuls and the all-reduces of a one-rank group: P, Q, the
    decompressed tensor and the next state within atol 1e-5 (entries of
    order 1; the QRs and matmuls sum in another order); 1-D leaves pass
    through bit for bit."""
    x = inputs(shape)
    port = C.PowerSGDCompressor(rank=rank, group=group)
    ref = JC.PowerSGDCompressor(rank=rank)
    state = port.init_state(torch.from_numpy(x))
    jstate = ref.init_state(jnp.asarray(x))
    if len(shape) == 1:
        assert state is None and jstate is None
    else:
        np.testing.assert_allclose(state.numpy(), np.asarray(jstate),
                                   rtol=0, atol=2e-6)
    payload, ctx, nstate = port.compress(torch.from_numpy(x), state, KEY)
    out = port.decompress(payload, ctx)

    def jfn(a, q):
        p, c, s = ref.compress(a, q, jax.random.key(0))
        return p, (None if c is None else c[:2]), s, ref.decompress(p, c)

    jp, jctx, jns, jout = _jax_one_device(jfn, jnp.asarray(x), jstate)
    if len(shape) == 1:
        same_bits(payload[0], jp[0])
        same_bits(out, jout)
        return
    assert payload == () and jp == ()
    for a, b in ((ctx[0], jctx[0]), (ctx[1], jctx[1]), (nstate, jns),
                 (out, jout)):
        np.testing.assert_allclose(as_np(a), np.asarray(b), rtol=0,
                                   atol=1e-5)
    p = ctx[0]
    eye = torch.eye(p.shape[1])
    torch.testing.assert_close(p.T @ p, eye, rtol=0, atol=1e-5)


def test_powersgd_state_rank_wire_bytes_and_warm_start(group):
    with pytest.raises(ValueError, match="state_rank"):
        C.PowerSGDCompressor(rank=4, state_rank=2).init_state(
            torch.ones(8, 8))
    x = torch.from_numpy(inputs((40, 25)))
    padded = C.PowerSGDCompressor(rank=2, state_rank=4, group=group)
    state = padded.init_state(x)
    assert tuple(state.shape) == (25, 4)
    _, _, nstate = padded.compress(x, state, KEY)
    torch.testing.assert_close(nstate[:, 2:], state[:, 2:], rtol=0, atol=0)
    for shape in ((1000,), (3, 3, 16, 8), (40, 25), (7, 2048)):
        for r in (1, 2, 4):
            assert C.PowerSGDCompressor(rank=r).wire_nbytes(
                shape, torch.float32) == JC.PowerSGDCompressor(
                    rank=r).wire_nbytes(shape, jnp.float32)
    cold = C.PowerSGDCompressor(rank=2, warm_start=False, group=group)
    (_, ctx_a, _), (_, ctx_b, _) = (cold.compress(x, state, KEY),
                                    cold.compress(x, state, KEY))
    torch.testing.assert_close(ctx_a[0], ctx_b[0], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["Allreduce", "Allgather", "Broadcast",
                                  "Identity"])
def test_powersgd_empty_payload_goes_straight_to_decompress(group, name):
    """PowerSGD exchanges inside ``compress`` and sends an empty payload:
    each communicator hands it to ``decompress`` as it is (no gather, no
    sum, no second mean), as the JAX package's do."""
    from grace_tpu_torch import comm
    codec = C.PowerSGDCompressor(rank=2, group=group)
    x = torch.from_numpy(inputs((40, 25)))
    state = codec.init_state(x)
    payload, ctx, _ = codec.compress(x, state, KEY)
    assert payload == ()
    out = getattr(comm, name)(group=group).exchange(payload, ctx, codec)
    torch.testing.assert_close(out, codec.decompress(payload, ctx), rtol=0,
                               atol=0)


def test_dgc_memory_clips_over_the_group(group):
    """With ``gradient_clipping`` the memory clips at the root mean square
    of the group's squared sums (one rank: the leaf's own norm)."""
    x = inputs((40, 25))
    port = M.DgcMemory(gradient_clipping=True, group=group)
    ref = JM.DgcMemory(gradient_clipping=True)
    state = port.init_state(torch.from_numpy(x))
    jstate = ref.init_state(jnp.asarray(x))
    for step in range(3):
        g = x * (step + 1)
        comp, state = port.compensate(torch.from_numpy(g), state)
        jcomp, jstate = _jax_one_device(ref.compensate, jnp.asarray(g),
                                        jstate)
        np.testing.assert_allclose(comp.numpy(), np.asarray(jcomp),
                                   rtol=2e-6, atol=1e-6)


# -- memories -------------------------------------------------------------------

MEMORY_CASES = {
    # (port memory, JAX memory, port codec, JAX codec, rtol): the memory
    # math rounds as XLA's FMA contractions allow (momentum·u + g,
    # state + lr·x), and each codec's own reduction.
    "dgc": (M.DgcMemory(), JM.DgcMemory(), C.DgcCompressor(0.05),
            JC.DgcCompressor(0.05), 2e-6),
    "efsignsgd": (M.EFSignSGDMemory(lr=0.3), JM.EFSignSGDMemory(lr=0.3),
                  C.EFSignSGDCompressor(lr=0.3),
                  JC.EFSignSGDCompressor(lr=0.3), 2e-6),
    "powersgd_1d": (M.PowerSGDMemory(), JM.PowerSGDMemory(),
                    C.PowerSGDCompressor(), JC.PowerSGDCompressor(), 0.0),
}


def _tree_close(a, b, rtol):
    if a is None:
        assert b is None
        return
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _tree_close(a[k], b[k], rtol)
        return
    np.testing.assert_allclose(as_np(a), np.asarray(b), rtol=rtol,
                               atol=1e-6 if rtol else 0)


@pytest.mark.parametrize("name", sorted(MEMORY_CASES))
def test_memory_matches_jax(name):
    """Three steps of compensate → compress → update on both sides, the
    port fed its own states: every compensated tensor and state."""
    pm, jm, pc, jc, rtol = MEMORY_CASES[name]
    shape = (1000,) if name.endswith("1d") else (40, 25)
    x = inputs(shape)
    state = pm.init_state(torch.from_numpy(x))
    jstate = jm.init_state(jnp.asarray(x))
    _tree_close(state, jstate, rtol)

    @jax.jit
    def jstep(g, s, k):
        comp, s = jm.compensate(g, s)
        payload, ctx, _ = jc.compress(comp, None, k)
        return comp, jm.update(comp, payload, ctx, jc, s)

    for step in range(3):
        g = x * np.float32(1 + 0.5 * step)
        key = JaxKey(0, step, 0)
        comp, state = pm.compensate(torch.from_numpy(g), state)
        payload, ctx, _ = pc.compress(comp, None, key)
        state = pm.update(comp, payload, ctx, pc, state)
        jcomp, jstate = jstep(jnp.asarray(g), jstate, jax_key_of(key))
        _tree_close(comp, jcomp, rtol)
        _tree_close(state, jstate, rtol)


def test_powersgd_memory_update_uses_the_factors():
    x = torch.from_numpy(inputs((40, 25)))
    mem = M.PowerSGDMemory()
    state = mem.init_state(x)
    comp, _ = mem.compensate(x, state)
    p, q = torch.linalg.qr(torch.ones(40, 2) + torch.eye(40, 2))[0], \
        torch.ones(25, 2)
    got = mem.update(comp, (), (p, q, (40, 25)), C.PowerSGDCompressor(),
                     state)
    want = JM.PowerSGDMemory().update(
        jnp.asarray(comp.numpy()), (), (jnp.asarray(p.numpy()),
                                        jnp.asarray(q.numpy()), (40, 25)),
        JC.PowerSGDCompressor(), jnp.asarray(state.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_twoshot_refuses_the_dgc_memory_under_stage2_feedback(group):
    from grace_tpu_torch import comm
    with pytest.raises(TypeError, match="DgcMemory"):
        comm.TwoShotAllreduce(stage2_feedback=True).step(
            torch.ones(16), M.DgcMemory().init_state(torch.ones(16)), None,
            M.DgcMemory(), C.CyclicTopKCompressor(0.5), LeafKey(0, 0, 0))


# -- the helper -------------------------------------------------------------------

def _fields(obj, skip=("axis_name", "group")):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if f.name not in skip}


@pytest.mark.parametrize("params", [
    {}, {"compress_ratio": 0.05}, {"quantum_num": 16, "momentum": 0.5},
    {"compress_rank": 3, "lr": 0.2, "threshold": 0.3,
     "capacity_ratio": 0.1, "recall_target": 0.8,
     "topk_algorithm": "approx"}], ids=["defaults", "ratio", "q", "keys"])
def test_helper_builds_every_name_with_jax_defaults(params):
    from grace_tpu.helper import _build_compressor, _build_memory
    from grace_tpu_torch.helper import COMPRESSORS, MEMORIES
    for name in COMPRESSORS:
        p = dict(params, compressor=name)
        port = grace_from_params(p).compressor
        ref = _build_compressor(p, "data")
        assert type(port).__name__ == type(ref).__name__, name
        pf, jf = _fields(port), _fields(ref)
        if name in NEW_CODECS:
            assert sorted(pf) == sorted(jf), name
        assert {k: v for k, v in pf.items() if k in jf} == \
            {k: v for k, v in jf.items() if k in pf}, name
    for name in MEMORIES:
        p = dict(params, memory=name)
        port = grace_from_params(p).memory
        ref = _build_memory(p, "data")
        assert type(port).__name__ == type(ref).__name__, name
        assert _fields(port) == _fields(ref), name
    for name in ("nonsense", "topk8"):
        with pytest.raises(ValueError, match="unknown compressor"):
            grace_from_params({"compressor": name})
        with pytest.raises(ValueError):
            _build_compressor({"compressor": name}, "data")


def test_helper_passes_the_group_to_the_collective_codecs():
    g = object()
    built = grace_from_params({"compressor": "powersgd", "compress_rank": 4,
                               "memory": "dgc", "gradient_clipping": True,
                               "momentum": 0.5}, group=g)
    assert built.compressor.group is g and built.compressor.rank == 4
    assert built.memory.group is g and built.memory.gradient_clipping
    assert built.memory.momentum == 0.5
    assert grace_from_params({"compressor": "sketch"}).compressor.bins == 256
    assert grace_from_params({"compressor": "dgc"}).compressor \
        .compress_ratio == 0.01
    lr = grace_from_params({"compressor": "efsignsgd", "memory": "efsignsgd",
                            "lr": 0.25})
    assert lr.compressor.lr == lr.memory.lr == 0.25
    assert lr.memory.linear_feedback_coeffs == (1.0, 0.25)


def test_size_flags_match_jax():
    from grace_tpu_torch.helper import COMPRESSORS
    from grace_tpu.helper import _build_compressor
    for name in COMPRESSORS:
        port = grace_from_params({"compressor": name}).compressor
        ref = _build_compressor({"compressor": name}, "data")
        for flag in ("tensors_size_are_same", "average", "payload_algebra",
                     "supports_hop_requant", "vote_aggregate"):
            assert getattr(port, flag) == getattr(ref, flag), (name, flag)


# -- catalog-wide checks (the JAX package's tests/test_compressors.py) -----------

def _catalog():
    from grace_tpu_torch.helper import COMPRESSORS
    return COMPRESSORS


@pytest.mark.parametrize("name", _catalog())
def test_payload_shapes_are_value_independent(name):
    """A payload's shapes and dtypes, and ctx's static entries, depend on
    the input's shape alone."""
    c = grace_from_params({"compressor": name}).compressor
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=60).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=60) * 1e6).astype(np.float32))
    pa, ctxa, _ = c.compress(a, c.init_state(a), LeafKey(0, 0, 0))
    pb, ctxb, _ = c.compress(b, c.init_state(b), LeafKey(0, 0, 0))
    assert [(tuple(p.shape), p.dtype) for p in pa] == \
        [(tuple(p.shape), p.dtype) for p in pb]

    def static(ctx):
        if isinstance(ctx, torch.Tensor):
            return []
        if isinstance(ctx, (tuple, list)):
            return [s for c in ctx for s in static(c)]
        return [ctx]

    assert static(ctxa) == static(ctxb)


@pytest.mark.parametrize("case", ["zeros", "tiny", "single", "constant"])
@pytest.mark.parametrize("name", _catalog())
def test_degenerate_inputs_stay_finite(name, case):
    c = grace_from_params({"compressor": name}).compressor
    x = {"zeros": torch.zeros(48), "tiny": torch.full((48,), 1e-30),
         "single": torch.zeros(1), "constant": torch.full((48,), 3.25)}[case]
    p, ctx, _ = c.compress(x, c.init_state(x), LeafKey(0, 0, 1))
    d = c.decompress(p, ctx)
    assert d.shape == x.shape and d.dtype == x.dtype
    assert bool(torch.all(torch.isfinite(d)))


# -- bytes ------------------------------------------------------------------------

NEW_CODECS = ["powersgd", "dgc", "efsignsgd", "cyclictopk", "onebit",
              "terngrad", "natural", "threshold", "sketch", "u8bit", "adaq",
              "inceptionn"]


@pytest.mark.parametrize("name", NEW_CODECS)
def test_bytes_equal_jax(name):
    """``payload_nbytes`` (and PowerSGD's analytic ``wire_nbytes``) equal
    JAX's integers at three shapes and two settings, and so does every
    communicator's ``recv_link_bytes`` over the worlds and topologies of
    ``tests/test_torch_region.py`` fed each package's own count."""
    from test_torch_region import TOPOLOGIES, WORLDS, _comm_pairs, \
        _jax_topology

    from grace_tpu.helper import _build_compressor
    from grace_tpu.utils.metrics import payload_nbytes as jax_nbytes
    from grace_tpu_torch.utils.metrics import payload_nbytes
    pairs = _comm_pairs()
    for params in ({"compressor": name},
                   {"compressor": name, "compress_ratio": 0.05,
                    "quantum_num": 300, "compress_rank": 4}):
        port = grace_from_params(params).compressor
        ref = _build_compressor(params, "data")
        for shape in ((1000,), (37, 5), (3, 3, 16, 8)):
            want = jax_nbytes(ref, jax.ShapeDtypeStruct(shape, jnp.float32))
            got = payload_nbytes(port, (shape, torch.float32))
            assert got == want, (params, shape)
            assert payload_nbytes(port, torch.ones(shape)) == want
            n = int(np.prod(shape))
            for pc, jcm in pairs:
                for w in WORLDS:
                    for topo in TOPOLOGIES:
                        jt = None if topo is None else _jax_topology(topo)
                        try:
                            jl = jcm.recv_link_bytes(want, n, w, topology=jt)
                        except ValueError:
                            with pytest.raises(ValueError):
                                pc.recv_link_bytes(got, n, w, topology=topo)
                            continue
                        assert tuple(pc.recv_link_bytes(
                            got, n, w, topology=topo)) == tuple(jl)
