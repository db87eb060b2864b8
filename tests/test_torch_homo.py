"""The homomorphic path of the port against the JAX package: the
shared-scale QSGD and count-sketch codecs, and the homomorphic branches of
``Allreduce``,
``RingAllreduce`` and ``ReduceScatterAllreduce`` over real gloo groups of
2, 3 and 4 ranks.

The gloo ranks are processes spawned once per world size; each runs every
scenario of its world and saves its outputs (or the error it raised). The
JAX side runs ``Communicator.step`` inside ``shard_map`` on the first W
devices of the 8-device CPU mesh. JAX is imported inside the JAX helpers
only, so the workers stay light.

The shared-scale inputs lie on the integer lattice with max|x| equal to
``quantum_num``: the negotiated scale is then ``quantum_num`` itself and
every level is its value, so the encode is lossless and needs no noise,
and a wrong hop, a doubled partial or a lost mean shows up as an
integer-sized error. Outputs and residuals are compared bit for bit.
"""

import dataclasses
import functools
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from grace_tpu_torch import comm
from grace_tpu_torch import compressors as C
from grace_tpu_torch.core import Compressor, LeafKey, mean_scale
from grace_tpu_torch.ops.packing import PACKERS

N = 41                   # not a multiple of W: the shards are padded
TIMEOUT_S = 180
WORLDS = (2, 3, 4)
SKETCH = dict(compress_ratio=0.5, rows=3)

# name -> (codec, memory, communicator, pipeline, input, worlds run, worlds
# compared with the JAX package).
SCENARIOS = {
    "homo7_allreduce": ("homo7", "residual", "allreduce", 1, 7, WORLDS,
                        WORLDS),
    "homo7_ring": ("homo7", "residual", "ring", 1, 7, WORLDS, WORLDS),
    "homo7_ring_p2": ("homo7", "residual", "ring", 2, 7, WORLDS, WORLDS),
    "homo7_rscatter": ("homo7", "residual", "rscatter", 1, 7, WORLDS,
                       WORLDS),
    "none_rscatter": ("none", "none", "rscatter", 1, 7, WORLDS, (3,)),
    "homo1p4_ring": ("homo1p4", "residual", "ring", 1, 1, WORLDS, WORLDS),
    "homo1p4_rscatter": ("homo1p4", "residual", "rscatter", 1, 1, WORLDS,
                         WORLDS),
    "homo1p4_allreduce": ("homo1p4", "none", "allreduce", 1, 1, WORLDS, ()),
    "homo32i8_allreduce": ("homo32i8", "none", "allreduce", 1, 32, WORLDS,
                           ()),
    "homo32i8_ring": ("homo32i8", "none", "ring", 1, 32, WORLDS, ()),
    "homo32i8_rscatter": ("homo32i8", "none", "rscatter", 1, 32, WORLDS, ()),
    "homo1p2_allreduce": ("homo1p2", "none", "allreduce", 1, 1, (2,), ()),
    "homo1p2_ring": ("homo1p2", "none", "ring", 1, 1, (2,), ()),
    "homo1p2_rscatter": ("homo1p2", "none", "rscatter", 1, 1, (2,), ()),
    "topk_rscatter": ("topk", "residual", "rscatter", 1, None, (2, 4), (4,)),
    "qsgd4_rscatter": ("qsgd4", "none", "rscatter", 1, None, (2, 4), ()),
    "sketch_allreduce": ("sketch", "none", "allreduce", 1, 8, (4,), (4,)),
    "sketch_ring": ("sketch", "none", "ring", 1, 8, (4,), (4,)),
    "sketch_rscatter": ("sketch", "none", "rscatter", 1, 8, (4,), (4,)),
}


def _inputs(world, q):
    """``(world, N)`` float32 inputs: integers in ``[-q, q]`` with
    ``x[0, 0] = q`` (so max|x| is ``q``), or normals for ``q=None``."""
    rng = np.random.default_rng(100 + world + (q or 0))
    if q is None:
        return rng.standard_normal((world, N)).astype(np.float32)
    x = rng.integers(-q, q + 1, (world, N)).astype(np.float32)
    x[0, 0] = q
    return x


def _mean(x):
    """The mean as both packages compute it: the sum times the float32
    reciprocal of W (equal to ``x.mean(0)`` for W a power of two)."""
    return x.sum(0) * np.float32(mean_scale(x.shape[0]))


@dataclasses.dataclass(frozen=True)
class _JaxTableKey(LeafKey):
    """A key that carries the JAX package's draws for every fold path a
    scenario reaches, made in the parent so that the workers need no JAX:
    ``seeds`` maps a fold path to the kernel seed JAX's QSGD draws under
    that key (``randint(key, (), 0, 2**31 - 1)``), and ``hashes`` maps
    ``(fold path, numel)`` to JAX's count-sketch ``(idx, signs)``."""

    seeds: tuple = ()
    hashes: tuple = ()

    def seed_int32(self) -> int:
        return dict(self.seeds)[self.folds]


@dataclasses.dataclass(frozen=True)
class _JaxHashSketch(C.CountSketchCompressor):
    """Count sketch with the JAX package's hashes (from a _JaxTableKey)."""

    def _hashes(self, rng, numel, device):
        idx, signs = dict(rng.hashes)[(rng.folds, numel)]
        return (torch.from_numpy(idx).long().to(device),
                torch.from_numpy(signs).float().to(device))


def _jax_key(folds=(), seed=0):
    import jax
    k = jax.random.key(seed)
    for f in folds:
        k = jax.random.fold_in(k, f)
    return k


@functools.cache
def _jax_tables(world):
    import jax
    import jax.numpy as jnp

    from grace_tpu import compressors as JC
    draw = jax.jit(lambda k: jax.random.randint(k, (), 0, 2**31 - 1,
                                                jnp.int32))
    seeds = tuple(((i,), int(draw(_jax_key((i,)))))
                  for i in range(world + 1))
    sketch = JC.CountSketchCompressor(**SKETCH)
    paths = [((), N)] + [((c,), -(-N // world)) for c in range(world)]
    hashes = tuple(((folds, n), tuple(np.asarray(a) for a in
                                      sketch._hashes(_jax_key(folds), n)))
                   for folds, n in paths)
    return seeds, hashes


def _port_triad(name):
    from grace_tpu_torch import memories as M
    codec, memory, communicator, pipeline = SCENARIOS[name][:4]
    comp = {"homo7": C.HomoQSGDCompressor(quantum_num=7),
            "homo1p4": C.HomoQSGDCompressor(quantum_num=1, accum_bits=4,
                                            use_pallas=True),
            "homo32i8": C.HomoQSGDCompressor(quantum_num=32,
                                             accum_dtype="int8"),
            "homo1p2": C.HomoQSGDCompressor(quantum_num=1, accum_bits=2),
            "none": C.NoneCompressor(),
            "topk": C.TopKCompressor(compress_ratio=0.3, algorithm="chunk"),
            "qsgd4": C.QSGDCompressor(quantum_num=7, use_pallas=True),
            "sketch": _JaxHashSketch(**SKETCH)}[codec]
    mem = {"none": M.NoneMemory(), "residual": M.ResidualMemory()}[memory]
    cm = {"ring": comm.RingAllreduce(pipeline=pipeline),
          "rscatter": comm.ReduceScatterAllreduce(),
          "allreduce": comm.Allreduce()}[communicator]
    return comp, mem, cm


def _worker(rank, world, init_file, out_path, tables):
    from grace_tpu_torch.parallel import init_process_group

    init_process_group("cpu", rank=rank, world_size=world,
                       init_method=f"file://{init_file}")
    seeds, hashes = tables
    try:
        out = {}
        for name, spec in SCENARIOS.items():
            if world not in spec[5]:
                continue
            x = torch.from_numpy(_inputs(world, spec[4])[rank])
            comp, mem, cm = _port_triad(name)
            key = _JaxTableKey(0, 0, 0, seeds=seeds, hashes=hashes)
            try:
                o, ms, _ = cm.step(x.clone(), mem.init_state(x), None, mem,
                                   comp, key)
            except (TypeError, ValueError) as e:
                out[f"{name}/error"] = np.array(f"{type(e).__name__}: {e}")
                continue
            out[f"{name}/out"] = o.numpy()
            if ms is not None:
                out[f"{name}/mem"] = ms.numpy()
        np.savez(out_path.format(rank=rank), **out)
    finally:
        torch.distributed.destroy_process_group()


@functools.cache
def _port_results(world, tmp):
    out_path = f"{tmp}/w{world}_rank{{rank}}.npz"
    ctx = mp.start_processes(
        _worker, args=(world, f"{tmp}/store{world}", out_path,
                       _jax_tables(world)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world}-rank gloo run did not finish in "
                        f"{TIMEOUT_S} s")
    results = []
    for r in range(world):
        with np.load(out_path.format(rank=r)) as data:
            results.append({k: data[k] for k in data.files})
    return results


@pytest.fixture(scope="module")
def port_tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("homo"))


def _jax_triad(name):
    from grace_tpu import comm as jcomm
    from grace_tpu import compressors as JC
    from grace_tpu import memories as JM
    codec, memory, communicator, pipeline = SCENARIOS[name][:4]
    comp = {"homo7": JC.HomoQSGDCompressor(quantum_num=7),
            "homo1p4": JC.HomoQSGDCompressor(quantum_num=1, accum_bits=4,
                                             use_pallas=True),
            "homo32i8": JC.HomoQSGDCompressor(quantum_num=32,
                                              accum_dtype="int8"),
            "homo1p2": JC.HomoQSGDCompressor(quantum_num=1, accum_bits=2),
            "none": JC.NoneCompressor(),
            "topk": JC.TopKCompressor(compress_ratio=0.3, algorithm="chunk"),
            "qsgd4": JC.QSGDCompressor(quantum_num=7, use_pallas=True),
            "sketch": JC.CountSketchCompressor(**SKETCH)}[codec]
    mem = {"none": JM.NoneMemory(), "residual": JM.ResidualMemory()}[memory]
    cm = {"ring": jcomm.RingAllreduce(pipeline=pipeline),
          "rscatter": jcomm.ReduceScatterAllreduce(),
          "allreduce": jcomm.Allreduce()}[communicator]
    return comp, mem, cm


@functools.cache
def _jax_results(name, world):
    """(out, mem) of every rank: the JAX step on a W-device submesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from grace_tpu.parallel import shard_map

    comp, mem, cm = _jax_triad(name)
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))

    def body(x):
        x = x[0]
        ms = mem.init_state(x)
        out, ms, _ = cm.step(x, ms, comp.init_state(x), mem, comp,
                             jax.random.key(0))
        return out[None], (ms if ms is not None else jnp.zeros_like(x))[None]

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=P("data"),
                           out_specs=(P("data"), P("data")),
                           check_vma=False))
    out, ms = fn(jnp.asarray(_inputs(world, SCENARIOS[name][4])))
    return np.asarray(out), np.asarray(ms)


def _compared():
    return [(w, s) for s, spec in SCENARIOS.items() for w in spec[6]]


@pytest.mark.parametrize("world,name", _compared())
def test_exchanges_match_jax_bit_for_bit(world, name, port_tmp):
    port = _port_results(world, port_tmp)
    want_out, want_mem = _jax_results(name, world)
    for r in range(world):
        assert f"{name}/error" not in port[r], port[r].get(f"{name}/error")
        np.testing.assert_array_equal(port[r][f"{name}/out"].view(np.int32),
                                      want_out[r].view(np.int32))
        if f"{name}/mem" in port[r]:
            np.testing.assert_array_equal(
                port[r][f"{name}/mem"].view(np.int32),
                want_mem[r].view(np.int32))
        # The exchange is global: every rank ends with the same update.
        np.testing.assert_array_equal(port[r][f"{name}/out"],
                                      port[0][f"{name}/out"])


@pytest.mark.parametrize("name", ["homo7_allreduce", "homo7_ring",
                                  "homo7_ring_p2", "homo7_rscatter",
                                  "none_rscatter", "homo1p4_ring",
                                  "homo1p4_rscatter"])
@pytest.mark.parametrize("world", WORLDS)
def test_lattice_exchanges_are_the_exact_mean(world, name, port_tmp):
    """On the lattice the payload-space sums are exact: the output is the
    mean (the sum times the reciprocal of W, which is ``x.mean(0)`` at
    W = 2 and 4, within one rounding of it at W = 3), and the residual of
    the one lossless encode is zero."""
    x = _inputs(world, SCENARIOS[name][4])
    port = _port_results(world, port_tmp)
    for r in range(world):
        np.testing.assert_array_equal(port[r][f"{name}/out"], _mean(x))
        np.testing.assert_allclose(port[r][f"{name}/out"], x.mean(0),
                                   rtol=2**-23, atol=0)
        if f"{name}/mem" in port[r]:
            np.testing.assert_array_equal(port[r][f"{name}/mem"],
                                          np.zeros(N, np.float32))


@pytest.mark.parametrize("world", WORLDS)
def test_overflow_gate_fires_at_the_world_jax_fires(world, port_tmp):
    """int8 at q=32 sums exactly up to W = 127 // 32 = 3, and 2-bit fields
    at q=1 up to W = 1: both packages run within the bound and raise the
    same ValueError beyond it, in all three communicators."""
    port = _port_results(world, port_tmp)
    for cm in ("allreduce", "ring", "rscatter"):
        for name, bound in ((f"homo32i8_{cm}", 3), (f"homo1p2_{cm}", 1)):
            if world not in SCENARIOS[name][5]:
                continue
            if world > bound:
                err = str(port[0][f"{name}/error"])
                assert err.startswith("ValueError") and \
                    "payload_sum_max_world" in err, err
                with pytest.raises(ValueError,
                                   match="payload_sum_max_world"):
                    _jax_results(name, world)
            else:
                assert f"{name}/error" not in port[0]
                np.testing.assert_allclose(
                    port[0][f"{name}/out"], _inputs(world, 32).mean(0),
                    atol=32 * 0.5)


def test_packed_allreduce_defect_is_refused(port_tmp):
    """The JAX ``Allreduce`` psums packed 4-bit level bytes: at W=2 a carry
    crosses from the low field into the high one (two -1 levels are
    ``0x0F + 0x0F = 0x1E``), so its result is not the mean. The port
    raises instead, at every W > 1, and names the communicators that sum
    packed fields."""
    x = _inputs(2, 1)
    want, _ = _jax_results("homo1p4_allreduce", 2)
    assert (want[0] != x.mean(0)).any()
    for world in WORLDS:
        err = str(_port_results(world, port_tmp)[0]["homo1p4_allreduce/error"])
        assert err.startswith("TypeError"), err
        assert "corrupt packed fields" in err and "rscatter" in err


@pytest.mark.parametrize("world", [2, 4])
def test_rscatter_requant_paths(world, port_tmp):
    """rscatter's single-requant path: under Top-K chunk the port runs
    every rank's decode and the one re-encode as JAX does, bit for bit at
    W=4 (test_exchanges_match_jax_bit_for_bit); under QSGD 4-bit, with the
    port's kernels given JAX's seeds, it agrees with JAX within four ulps
    (JAX's interpret-mode decode fuses its multiply-adds), and both are
    within a level of the mean."""
    x = _inputs(world, None)
    port = _port_results(world, port_tmp)
    for r in range(world):
        for name in ("topk_rscatter", "qsgd4_rscatter"):
            np.testing.assert_array_equal(port[r][f"{name}/out"],
                                          port[0][f"{name}/out"])
    if world == 4:
        got = port[0]["qsgd4_rscatter/out"]
        want, _ = _jax_results("qsgd4_rscatter", world)
        np.testing.assert_allclose(got, want[0], rtol=2**-21, atol=0)
        assert (got != 0).sum() > N // 4
    scale = np.abs(x).sum(0).max() * 2
    assert np.abs(port[0]["qsgd4_rscatter/out"] - x.mean(0)).max() <= scale


# -- the codecs ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _JaxUniformKey(LeafKey):
    """A key whose uniforms are JAX's ``jax.random.uniform`` under the
    counterpart key ``fold_in(key(seed), *folds)``."""

    def uniform(self, shape, device):
        import jax
        k = jax.random.key(self.seed)
        for f in self.folds:
            k = jax.random.fold_in(k, f)
        return torch.from_numpy(np.array(
            jax.random.uniform(k, tuple(shape)))).to(device)


HOMO_CONFIGS = [dict(quantum_num=7), dict(quantum_num=7, accum_dtype="int8"),
                dict(quantum_num=3, accum_dtype="int32"),
                dict(quantum_num=127), dict(quantum_num=1, accum_bits=2),
                dict(quantum_num=3, accum_bits=3),
                dict(quantum_num=7, accum_bits=4)]


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("cfg", HOMO_CONFIGS, ids=str)
def test_homoqsgd_levels_match_jax_given_its_uniforms(cfg, shared):
    import jax.numpy as jnp

    from grace_tpu import compressors as JC
    rng = np.random.default_rng(7)
    x = rng.standard_normal(1000).astype(np.float32)
    x[:3] = [0.0, -0.0, 0.0]
    scale = np.float32(np.abs(x).max() * 1.37) if shared else None
    key = _JaxUniformKey(3, 0, 0).fold(5)
    port = C.HomoQSGDCompressor(**cfg)
    jax_codec = JC.HomoQSGDCompressor(**cfg)
    kw = {} if scale is None else {"shared": torch.tensor(scale)}
    (got,), ctx, _ = port.compress(torch.from_numpy(x), None, key, **kw)
    jkw = {} if scale is None else {"shared": jnp.asarray(scale)}
    (want,), jctx, _ = jax_codec.compress(jnp.asarray(x), None,
                                          _jax_key((5,), seed=3), **jkw)
    assert got.dtype == getattr(torch, str(np.asarray(want).dtype))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.float32(ctx[2]).view(np.int32) == \
        np.float32(jctx[2]).view(np.int32)
    # Not trivially zero: real roundings happened.
    assert (got.numpy() != 0).sum() > 100


@pytest.mark.parametrize("accum_bits", [None, 4])
def test_homoqsgd_decompress_bit_for_bit(accum_bits):
    """Identical (summed) levels decode to identical bits at q=7, W=3 and
    a scale that is not a power of two: ``scale * float32(1/7)``, as XLA
    compiles ``scale / 7``, then the mean's ``* float32(1/3)``."""
    import jax
    import jax.numpy as jnp

    from grace_tpu import compressors as JC
    cfg = dict(quantum_num=7) if accum_bits is None else \
        dict(quantum_num=1, accum_bits=4)
    port, jax_codec = C.HomoQSGDCompressor(**cfg), JC.HomoQSGDCompressor(**cfg)
    rng = np.random.default_rng(1)
    q = cfg["quantum_num"]
    levels = rng.integers(-q, q + 1, (3, 777)).sum(0)
    scale = np.float32(0.3721)
    if accum_bits is None:
        payload = levels.astype(np.int16)
    else:
        payload = PACKERS[4][0](torch.from_numpy(
            np.mod(levels, 16).astype(np.uint8))).numpy()
    ctx = ((777,), torch.float32, torch.tensor(scale))
    got = port.decompress((torch.from_numpy(payload),), ctx) * mean_scale(3)
    # Under jit, as the JAX package always runs it (eager JAX divides
    # by 3 with an IEEE division instead).
    want = jax.jit(lambda p, s: jax_codec.decompress(
        (p,), ((777,), jnp.float32, s)) / 3)(jnp.asarray(payload),
                                              jnp.asarray(scale))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_packed_payload_algebra_matches_jax(bits, world):
    """``payload_add`` (the ring hop: the received payload and this rank's,
    as separate tensors) and ``payload_sum`` (the reduce-scatter: the rows
    of the all-to-all's ``(W, nbytes)`` output, which lie ``nbytes``
    apart) through ``wire.packed_int_accumulate_rows`` equal the JAX
    package's payload algebra byte for byte: on levels within the field,
    its interpret-mode Pallas kernel and its staged path; on random bytes
    whose sums leave the field, its staged path (a floored mod)."""
    import jax.numpy as jnp

    from grace_tpu import compressors as JC
    q = 1
    port = C.HomoQSGDCompressor(quantum_num=q, accum_bits=bits,
                                use_pallas=True)
    assert port.wire_fused()
    jax_fused = JC.HomoQSGDCompressor(quantum_num=q, accum_bits=bits,
                                      use_pallas=True)
    jax_staged = JC.HomoQSGDCompressor(quantum_num=q, accum_bits=bits,
                                       use_pallas=False)
    rng = np.random.default_rng(10 * bits + world)
    n = 1001                                     # 251 to 501 bytes a payload
    ceil = (1 << (bits - 1)) - 1
    levels = np.zeros((world, n), np.int64)      # sums within the field
    levels[rng.integers(0, world, n), np.arange(n)] = rng.integers(
        -ceil, ceil + 1, n)
    bounded = torch.stack([PACKERS[bits][0](torch.from_numpy(
        np.mod(lv, 1 << bits).astype(np.uint8))) for lv in levels])
    wraps = torch.from_numpy(rng.integers(0, 256, tuple(bounded.shape))
                             .astype(np.uint8))
    for stacked, refs in ((bounded, (jax_fused, jax_staged)),
                          (wraps, (jax_staged,))):
        (got_sum,) = port.payload_sum((stacked,))
        ring = (stacked[0].clone(),)
        for r in range(1, world):
            ring = port.payload_add(ring, (stacked[r].clone(),))
        for ref in refs:
            (want_sum,) = ref.payload_sum((jnp.asarray(stacked.numpy()),))
            np.testing.assert_array_equal(got_sum.numpy(),
                                          np.asarray(want_sum))
            jring = (jnp.asarray(stacked[0].numpy()),)
            for r in range(1, world):
                jring = ref.payload_add(jring,
                                        (jnp.asarray(stacked[r].numpy()),))
            np.testing.assert_array_equal(ring[0].numpy(),
                                          np.asarray(jring[0]))


def test_homoqsgd_bounds_and_errors_match_jax():
    from grace_tpu import compressors as JC
    for dt in ("int8", "int16", "int32"):
        for q in (1, 3, 7, 32, 100, 127):
            a = C.HomoQSGDCompressor(quantum_num=q, accum_dtype=dt)
            b = JC.HomoQSGDCompressor(quantum_num=q, accum_dtype=dt)
            assert a.payload_sum_max_world() == b.payload_sum_max_world()
            assert a.negotiation_nbytes(q) == b.negotiation_nbytes(q)
    for bits in (2, 3, 4):
        for q in range(1, (1 << (bits - 1))):
            a = C.HomoQSGDCompressor(quantum_num=q, accum_bits=bits)
            b = JC.HomoQSGDCompressor(quantum_num=q, accum_bits=bits)
            assert a.payload_sum_max_world() == b.payload_sum_max_world()
            assert a.wire_fused() and not dataclasses.replace(
                a, use_pallas=False).wire_fused()
    for bad in (dict(accum_bits=5), dict(accum_bits=1),
                dict(quantum_num=2, accum_bits=2),
                dict(quantum_num=8, accum_bits=4), dict(accum_dtype="uint8"),
                dict(accum_dtype="float16"), dict(quantum_num=0),
                dict(quantum_num=128, accum_dtype="int8"),
                dict(use_pallas=1)):
        with pytest.raises(ValueError):
            JC.HomoQSGDCompressor(**bad)
        with pytest.raises(ValueError):
            C.HomoQSGDCompressor(**bad)
    codec = C.HomoQSGDCompressor()
    assert codec.payload_algebra == "shared_scale"
    assert not codec.supports_hop_requant and codec.summable_payload
    assert not codec.wire_fused()                 # int16 wire: no kernel


def test_payload_sum_is_dtype_pinned():
    t = torch.tensor([[30000, -5], [30000, 7]], dtype=torch.int16)
    (s,) = Compressor().payload_sum((t,))
    assert s.dtype == torch.int16
    assert s.tolist() == [60000 - 65536, 2]       # wraps as int16 does


def test_countsketch_tables_and_merge_match_jax():
    """With JAX's hashes given through ``_hashes``, the port's tables equal
    JAX's on integer inputs, tables merge exactly (``sketch(x) + sketch(y)
    == sketch(x + y)``), and the merged table decodes to JAX's bits."""
    import jax.numpy as jnp

    from grace_tpu import compressors as JC
    rng = np.random.default_rng(4)
    x, y = (rng.integers(-8, 9, 128).astype(np.float32) for _ in range(2))
    jc = JC.CountSketchCompressor(**SKETCH)
    jkey = _jax_key((3,))
    hashes = ((((3,), 128), tuple(np.asarray(a) for a in
                                  jc._hashes(jkey, 128))),)
    key = _JaxTableKey(0, 0, 0, hashes=hashes).fold(3)
    port = _JaxHashSketch(**SKETCH)
    tables = [port.compress(torch.from_numpy(v), None, key)[0][0]
              for v in (x, y, x + y)]
    jtables = [np.asarray(jc.compress(jnp.asarray(v), None, jkey)[0][0])
               for v in (x, y, x + y)]
    for got, want in zip(tables, jtables):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal((tables[0] + tables[1]).numpy(),
                                  tables[2].numpy())
    _, ctx, _ = port.compress(torch.from_numpy(x), None, key)
    _, jctx, _ = jc.compress(jnp.asarray(x), None, jkey)
    got = port.decompress((tables[0] + tables[1],), ctx)
    want = jc.decompress((jnp.asarray(jtables[2]),), jctx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The port's own hashes: ctx is static data, and a decode draws the
    # same hashes again from the key.
    own = C.CountSketchCompressor(**SKETCH)
    (t,), ctx, _ = own.compress(torch.from_numpy(x), None, LeafKey(0, 1, 2))
    assert not any(isinstance(c, torch.Tensor) for c in ctx)
    assert t.shape == (3, 22)
    np.testing.assert_array_equal(
        own.decompress((t,), ctx).numpy(),
        own.decompress((t.clone(),), ctx).numpy())
    with pytest.raises(ValueError, match="odd"):
        C.CountSketchCompressor(rows=2)
    with pytest.raises(ValueError, match="compress_ratio"):
        C.CountSketchCompressor(compress_ratio=0.0)


# -- one-rank groups: the hoist and the gates --------------------------------

@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


def test_negotiation_hoist_runs_in_communicator_step(group):
    """``Communicator.step`` negotiates on the compensated tensor before
    the encode: compress receives the negotiated scale (the max magnitude
    of the compensated tensor, here 2 + 5), and the one-rank Allreduce of
    packed levels is JAX's W=1 result, the decode of its own payload."""
    from grace_tpu_torch.memories import NoneMemory, ResidualMemory
    x = torch.tensor([1.0, -2.0, 0.5, 0.0])
    state = torch.tensor([0.0, -5.0, 0.0, 0.0])
    mem = ResidualMemory()
    seen = []

    @dataclasses.dataclass(frozen=True)
    class Spy(C.HomoQSGDCompressor):
        def compress(self, x, state, rng, shared=None):
            seen.append(shared)
            return super().compress(x, state, rng, shared=shared)

    for cm in (comm.Allreduce(), comm.Allgather(), comm.Identity()):
        seen.clear()
        out, new, _ = cm.step(x, state.clone(), None, mem,
                              Spy(quantum_num=7), LeafKey(0, 0, 0))
        assert float(seen[0]) == 7.0
        np.testing.assert_allclose((out + new).numpy(),
                                   (x + state).numpy(), atol=1e-6)
    packed = C.HomoQSGDCompressor(quantum_num=1, accum_bits=4)
    y = torch.tensor([1.0, -1.0, 0.0, -1.0, 1.0])
    out, _, _ = comm.Allreduce().step(y, None, None, NoneMemory(), packed,
                                      LeafKey(0, 0, 0))
    np.testing.assert_array_equal(out.numpy(), y.numpy())


def test_rscatter_gates_raise_as_in_jax(group):
    from grace_tpu_torch.compressors import SignumCompressor, TopKCompressor
    from grace_tpu_torch.memories import NoneMemory
    rs, x, key, mem = comm.ReduceScatterAllreduce(), torch.ones(10), \
        LeafKey(0, 0, 0), NoneMemory()
    signum = SignumCompressor()
    with pytest.raises(TypeError, match="stateless"):
        rs.step(x, None, signum.init_state(x), mem, signum, key)

    @dataclasses.dataclass(frozen=True)
    class NoAlgebra(Compressor):
        def compress(self, x, state, rng):
            return (x,), None, state

        def decompress(self, payload, ctx):
            return payload[0]

    @dataclasses.dataclass(frozen=True)
    class TensorCtx(NoAlgebra):
        supports_hop_requant = True

        def compress(self, x, state, rng):
            return (x,), torch.linalg.vector_norm(x), state

    with pytest.raises(TypeError, match="neither"):
        rs.step(x, None, None, mem, NoAlgebra(), key)
    with pytest.raises(TypeError, match="data-free ctx"):
        rs.step(x, None, None, mem, TensorCtx(), key)
    with pytest.raises(TypeError, match="step"):
        rs.exchange((x,), None, NoAlgebra())
    # Top-K rides the single-requant path: at W=1 its own encode, twice.
    out, _, _ = rs.step(x, None, None, mem,
                        TopKCompressor(compress_ratio=0.5), key)
    assert out.shape == x.shape


def test_helper_builds_the_homomorphic_names():
    from grace_tpu import grace_from_params as jax_grace_from_params
    from grace_tpu_torch import grace_from_params
    for params in ({"compressor": "homoqsgd"},
                   {"compressor": "homoqsgd", "quantum_num": 1,
                    "accum_bits": 4, "use_pallas": True,
                    "communicator": "rscatter"},
                   {"compressor": "homoqsgd", "quantum_num": 32,
                    "accum_dtype": "int8", "communicator": "ring"},
                   {"compressor": "countsketch", "compress_ratio": 0.5,
                    "sketch_rows": 5, "communicator": "reduce_scatter"},
                   {"compressor": "countsketch",
                    "communicator": "rscatter_allreduce"}):
        got, want = grace_from_params(params), jax_grace_from_params(params)
        assert type(got.compressor).__name__ == \
            type(want.compressor).__name__
        assert type(got.communicator).__name__ == \
            type(want.communicator).__name__
        for f in dataclasses.fields(want.compressor):
            assert getattr(got.compressor, f.name) == \
                getattr(want.compressor, f.name), f.name
