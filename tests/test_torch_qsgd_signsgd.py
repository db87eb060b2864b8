"""The port's QSGD, signSGD and Signum codecs against the JAX package's.

Inputs are made with numpy from a seed. Where the JAX reference is
deterministic or rides the kernels' counter hash, the two packages are
held bit for bit; the staged QSGD path draws its uniforms from JAX's
threefry in one package and from ``torch.rand`` in the other, so there
they are held statistically (unbiasedness and QSGD's ``norm/q`` error
bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grace_tpu import compressors as jC
from grace_tpu_torch import comm, grace_from_params
from grace_tpu_torch.compressors import (QSGDCompressor, SignSGDCompressor,
                                         SignumCompressor)
from grace_tpu_torch.core import LeafKey, mean_scale
from grace_tpu_torch.memories import NoneMemory, ResidualMemory

# The three configurations of the quantized wire path (bench_all.py).
QSGD4_RING = {"compressor": "qsgd", "quantum_num": 7, "use_pallas": True,
              "memory": "none", "communicator": "ring", "fusion": "flat"}
QSGD_PALLAS = {"compressor": "qsgd", "quantum_num": 64, "use_pallas": True,
               "memory": "none", "communicator": "allgather",
               "fusion": "flat"}
SIGNSGD_VOTE = {"compressor": "signsgd", "memory": "residual",
                "communicator": "sign_allreduce", "fusion": "none"}


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _i32(a):
    return np.asarray(a).view(np.int32)


@dataclasses.dataclass(frozen=True)
class _FixedSeedKey(LeafKey):
    """A key whose kernel seed is given: the JAX package's threefry draw."""

    fixed: int = 0

    def seed_int32(self) -> int:
        return self.fixed


def _jax_seed(key):
    return int(jax.random.randint(key, (), 0, 2**31 - 1, jnp.int32))


@pytest.mark.parametrize("q", [3, 7, 127])
def test_decode_scale_is_xla_reciprocal_multiply(q):
    # A jitted norm / q is norm * float32(1/q): the port's decode scale.
    norms = np.random.default_rng(q).random(20000).astype(np.float32) * 10
    want = np.asarray(jax.jit(lambda n: n / q)(jnp.asarray(norms)))
    got = QSGDCompressor(quantum_num=q).decode_scale(torch.from_numpy(norms))
    np.testing.assert_array_equal(_i32(got.numpy()), _i32(want))
    # ... which is not the IEEE division, so the test pins something.
    ieee = (torch.from_numpy(norms) / q).numpy()
    assert (_i32(ieee) != _i32(want)).any()


@pytest.mark.parametrize("q", [3, 7, 127])
def test_decompress_bit_for_bit_on_identical_levels(q):
    x = _x((6, 50), seed=q)
    jc = jC.QSGDCompressor(quantum_num=q, use_pallas=False)
    tc = QSGDCompressor(quantum_num=q, use_pallas=False)
    payload, ctx, _ = jc.compress(jnp.asarray(x), None, jax.random.key(1))
    levels, norm = (np.asarray(p) for p in payload)
    want = jax.jit(lambda lv, n: jc.decompress((lv, n), ctx))(levels, norm)
    got = tc.decompress((torch.from_numpy(levels), torch.tensor(norm)),
                        ((6, 50), torch.float32))
    assert got.shape == (6, 50)
    np.testing.assert_array_equal(_i32(got.numpy()), _i32(want))


@pytest.mark.parametrize("q", [1, 3, 7, 64, 200])
def test_kernel_compress_matches_jax_given_its_seed(q):
    """The kernel path, seeded with JAX's own draw: the levels match bit for
    bit wherever the two norms (different reduction orders) agree."""
    x = _x(3000, seed=q + 1)
    key = jax.random.key(q)
    jc = jC.QSGDCompressor(quantum_num=q, use_pallas=True)
    tc = QSGDCompressor(quantum_num=q, use_pallas=True)
    (jl, jn), jctx, _ = jc.compress(jnp.asarray(x), None, key)
    (tl, tn), tctx, _ = tc.compress(torch.from_numpy(x), None,
                                    _FixedSeedKey(0, 0, 0,
                                                  fixed=_jax_seed(key)))
    np.testing.assert_allclose(tn.item(), float(jn), rtol=2e-7)
    assert tl.dtype == {1: torch.uint8, 3: torch.uint8, 7: torch.uint8,
                        64: torch.int8, 200: torch.int16}[q]
    if tn.item() == float(jn):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # Fed JAX's norm, the port decodes JAX's payload to JAX's bits.
    want = jax.jit(lambda lv, n: jc.decompress((lv, n), jctx))(jl, jn)
    got = tc.decompress((torch.from_numpy(np.asarray(jl)),
                         torch.tensor(np.asarray(jn))), tctx)
    np.testing.assert_array_equal(_i32(got.numpy()), _i32(want))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("q", [1, 3, 7, 64])
def test_staged_and_kernel_paths_are_unbiased_within_bound(q, use_pallas):
    """Statistical parity: every draw is within norm/q of x per element,
    and the mean of 400 draws is within 5 standard errors of x."""
    x = torch.from_numpy(_x(512, seed=3))
    norm = torch.linalg.vector_norm(x)
    tc = QSGDCompressor(quantum_num=q, use_pallas=use_pallas)
    draws = torch.stack([
        tc.decompress(*tc.compress(x, None, LeafKey(5, c, 0))[:2])
        for c in range(400)])
    bound = float(norm) / q
    assert (draws - x).abs().max() <= bound * (1 + 1e-6)
    se = bound / 2 / np.sqrt(400)                 # |error| <= bound, var <= b^2/4
    assert (draws.mean(0) - x).abs().max() <= 5 * se
    # The JAX staged path (threefry) meets the same bounds.
    jc = jC.QSGDCompressor(quantum_num=q, use_pallas=False)
    ctx = ((512,), jnp.float32)
    jdraws = jax.jit(jax.vmap(lambda k: jc.decompress(
        jc.compress(jnp.asarray(x.numpy()), None, k)[0], ctx)))(
            jax.random.split(jax.random.key(0), 400))
    jdraws = np.asarray(jdraws)
    assert np.abs(jdraws - x.numpy()).max() <= bound * (1 + 1e-6)
    assert np.abs(jdraws.mean(0) - x.numpy()).max() <= 5 * se


@pytest.mark.parametrize("q", [1, 3, 7])
def test_qsgd_decode_accumulate_is_the_staged_decode(q):
    """The ring hop's fused decode equals decompress + decompress, bit for
    bit (and the staged path runs when the kernels are off)."""
    tc = QSGDCompressor(quantum_num=q, use_pallas=True)
    assert tc.wire_fused()
    assert not QSGDCompressor(quantum_num=q, use_pallas=False).wire_fused()
    assert not QSGDCompressor(quantum_num=64).wire_fused()   # not packed
    ctx = ((1001,), torch.float32)
    pays = [tc.compress(torch.from_numpy(_x(1001, seed=s)), None,
                        LeafKey(0, s, 0))[0] for s in range(2)]
    fused = tc.decode_accumulate(pays, (ctx, ctx))
    staged = tc.decompress(pays[0], ctx) + tc.decompress(pays[1], ctx)
    np.testing.assert_array_equal(_i32(fused.numpy()), _i32(staged.numpy()))
    # Each payload decodes to the JAX package's bits (its decode runs
    # under jit, where norm / q is norm * float32(1/q)).
    jitted = jax.jit(lambda lv, n: jC.QSGDCompressor(
        quantum_num=q).decompress((lv, n), ((1001,), jnp.float32)))(
        jnp.asarray(pays[0][0].numpy()), jnp.asarray(pays[0][1].numpy()))
    np.testing.assert_array_equal(_i32(tc.decompress(pays[0], ctx).numpy()),
                                  _i32(jitted))


@pytest.mark.parametrize("use_pallas", [True, "auto", False])
def test_signsgd_codec_matches_jax(use_pallas):
    x = _x((33, 7), seed=4)
    x[0, :3] = [0.0, -0.0, 1e-30]
    jc = jC.SignSGDCompressor(use_pallas=True if use_pallas else False)
    tc = SignSGDCompressor(use_pallas=use_pallas)
    (jp,), jctx, _ = jc.compress(jnp.asarray(x), None, jax.random.key(0))
    (tp,), tctx, _ = tc.compress(torch.from_numpy(x), None, LeafKey(0, 0, 0))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(
        _i32(tc.decompress((tp,), tctx).numpy()),
        _i32(jc.decompress((jp,), jctx)))
    stacked = np.stack([np.asarray(jc.decompress((jp,), jctx))] * 3
                       + [-np.ones((33, 7), np.float32)] * 2)
    np.testing.assert_array_equal(
        tc.aggregate(torch.from_numpy(stacked)).numpy(),
        np.asarray(jc.aggregate(jnp.asarray(stacked))))
    assert not tc.average and tc.vote_aggregate and tc.supports_hop_requant
    # The sign hop's fused decode is the staged one.
    fused = tc.decode_accumulate([(tp,), (tp,)], (tctx, tctx))
    np.testing.assert_array_equal(
        fused.numpy(), (tc.decompress((tp,), tctx) * 2).numpy())


def test_signum_momentum_matches_jax_within_tolerance():
    """Signum's momentum over four steps: within rtol 1e-6 of JAX (XLA may
    fuse its multiply-add); the sign masks agree wherever the momentum is
    not within that tolerance of 0."""
    jc = jC.SignumCompressor(momentum=0.9, use_pallas=False)
    tc = SignumCompressor(momentum=0.9)
    js = jc.init_state(jnp.zeros(500))
    ts = tc.init_state(torch.zeros(500))
    assert set(ts) == {"momentum", "initialized"}
    def jstep(g, s):
        payload, _, s = jc.compress(g, s, jax.random.key(0))
        return payload, s

    step = jax.jit(jstep)
    for i in range(4):
        g = _x(500, seed=10 + i)
        (jp,), js = step(jnp.asarray(g), js)
        (tp,), _, ts = tc.compress(torch.from_numpy(g), ts, LeafKey(0, i, 0))
        jm = np.asarray(js["momentum"])
        np.testing.assert_allclose(ts["momentum"].numpy(), jm, rtol=1e-6,
                                   atol=1e-7)
        far = np.abs(jm) > 1e-5
        tbits = np.unpackbits(tp.numpy(), bitorder="little")[:500]
        jbits = np.unpackbits(np.asarray(jp), bitorder="little")[:500]
        np.testing.assert_array_equal(tbits[far], jbits[far])
        assert bool(ts["initialized"]) and bool(js["initialized"])
    assert not tc.supports_hop_requant and tc.payload_algebra is None


def test_grace_from_params_builds_the_wire_path_configs():
    g = grace_from_params(QSGD4_RING)
    assert g.compressor == QSGDCompressor(quantum_num=7, use_pallas=True)
    assert g.compressor.packed_wire and g.compressor.pack_width == 4
    assert g.communicator == comm.RingAllreduce(pipeline=1)
    assert isinstance(g.memory, NoneMemory) and g.fusion == "flat"
    g = grace_from_params(QSGD_PALLAS)
    assert g.compressor == QSGDCompressor(quantum_num=64, use_pallas=True)
    assert not g.compressor.packed_wire
    assert g.compressor.level_dtype == torch.int8
    assert isinstance(g.communicator, comm.Allgather) and g.fusion == "flat"
    g = grace_from_params(SIGNSGD_VOTE)
    assert g.compressor == SignSGDCompressor(use_pallas="auto")
    assert g.communicator == comm.SignAllreduce(vote_dtype="bfloat16")
    assert isinstance(g.memory, ResidualMemory) and g.fusion is None
    assert g.transform(seed=1).fusion is None
    # The JAX package's defaults and spellings.
    assert grace_from_params({"compressor": "qsgd"}).compressor == \
        QSGDCompressor(quantum_num=64, use_pallas="auto")
    assert grace_from_params({"compressor": "signum"}).compressor.momentum == 0.9
    assert grace_from_params({"communicator": "ring_allreduce",
                              "pipeline": 2}).communicator.pipeline == 2
    assert grace_from_params({"communicator": "signallreduce",
                              "vote_dtype": "float32"}).communicator == \
        comm.SignAllreduce(vote_dtype="float32")
    assert grace_from_params({"communicator": "allreduce"}).communicator \
        .vote_dtype == "bfloat16"
    assert QSGDCompressor(quantum_num=200).level_dtype == torch.int16
    assert [QSGDCompressor(quantum_num=q).pack_width for q in (1, 3, 7)] == \
        [2, 3, 4]


def test_leaf_key_fold_and_seed_draw():
    k = LeafKey(3, 4, 5)
    assert k.fold(0) != k and k.fold(0) == LeafKey(3, 4, 5).fold(0)
    assert k.fold(0).derived_seed() != k.fold(1).derived_seed()
    assert k.fold(1).fold(2).folds == (1, 2)
    seeds = {LeafKey(0, c, 0).fold(i).seed_int32() for c in range(8)
             for i in range(8)}
    assert len(seeds) == 64
    assert all(0 <= s < 2**31 - 1 for s in seeds)
    assert LeafKey(3, 4, 5).derived_seed() == k.derived_seed()   # no folds
    assert mean_scale(7) == float(np.float32(1) / np.float32(7))


def test_qsgd_rejects_bad_options():
    with pytest.raises(ValueError, match="use_pallas"):
        QSGDCompressor(use_pallas=1)
    with pytest.raises(ValueError, match="quantum_num"):
        QSGDCompressor(quantum_num=0)
    with pytest.raises(ValueError, match="use_pallas"):
        SignSGDCompressor(use_pallas="yes")


@pytest.mark.parametrize("cfg", [
    dict(SIGNSGD_VOTE, fusion="flat"),                  # a flat residual
    {"compressor": "signum", "momentum": 0.9, "memory": "none",
     "communicator": "sign_allreduce", "fusion": "none"}],
    ids=["signsgd_flat_residual", "signum_momentum"])
def test_resume_a_jax_run_in_the_port(tmp_path, cfg):
    """Two JAX steps, then the JAX state carried into the port
    (``convert.grace_state_from_jax``): the third step agrees."""
    from jax.sharding import Mesh, PartitionSpec as P

    from grace_tpu import grace_from_params as jax_grace_from_params
    from grace_tpu.parallel import shard_map
    from grace_tpu_torch.convert import grace_state_from_jax
    from grace_tpu_torch.parallel import init_process_group

    shapes = {"a": (5, 7), "b": (9,)}
    grads = [{n: _x(s, seed=10 * i + len(n)) for n, s in shapes.items()}
             for i in range(3)]
    jtx = jax_grace_from_params(cfg).transform(seed=0)

    def body(gs):
        state = jtx.init(gs[0])
        for g in gs[:2]:
            _, state = jtx.update(g, state)
        out, _ = jtx.update(gs[2], state)
        return state, out

    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jstate, jout = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(),),
                                     out_specs=P(), check_vma=False))(
        [{n: jnp.asarray(a) for n, a in g.items()} for g in grads])
    jstate = jax.device_get(jstate)
    state = grace_state_from_jax(jstate, seed=0)
    assert state.count == 2 and len(state.mem) == len(jstate.mem)
    if cfg["compressor"] == "signum":
        assert set(state.comp[0]) == {"momentum", "initialized"}
        assert bool(state.comp[0]["initialized"])
    else:
        assert state.mem[0].shape == (44,)               # one flat buffer
    init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    try:
        ttx = grace_from_params(cfg).transform(seed=0)
        out, new = ttx.update({n: torch.from_numpy(a)
                               for n, a in grads[2].items()}, state)
    finally:
        torch.distributed.destroy_process_group()
    for n in shapes:
        np.testing.assert_array_equal(out[n].numpy(), np.asarray(jout[n]))
    assert new.count == 3
