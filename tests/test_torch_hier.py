"""The port's two-level hierarchical all-reduce over real gloo groups, against
the JAX package's ``HierarchicalAllreduce`` on a W-device submesh.

The port's ranks are processes spawned once per world size (W=4 with
S=2, W=8 with S in {2, 4}); each runs every scenario of its world and saves
its outputs, or the error it raised. The JAX side runs ``Communicator.step``
inside ``shard_map`` on the first W devices of the 8-device CPU mesh, under
``jax.random.key(0)``. JAX is imported inside the JAX helpers only, so the
workers stay light. ``tests/test_torch_region.py`` runs the three-level
schedule through the same workers.

* ``none``, ``fp16``, randomk (given JAX's indices), homoqsgd (int16 at
  q=7, and packed 4-bit at q=1 where W stays under its bound of 7), the
  count sketch (given JAX's hashes) and signSGD with residual (staged, and
  through the kernels' plain versions) are held bit for bit: outputs and
  residuals. The homoqsgd inputs lie on
  its integer lattice, where the encode is lossless and draws no noise.
* Top-K 25% (chunk) with residual is held bit for bit too: its encodes are
  deterministic, and every partial sum and decode rounds as in JAX.
* QSGD 4-bit, staged, given JAX's uniforms: within four ulps, relative
  (XLA contracts the decode's multiply-adds). The JAX package's quantize
  kernels run in interpret mode off the TPU, and inside an 8-device
  ``shard_map`` with grouped gathers that run deadlocks (it hung at W=8
  every time, and once at W=4), so the reference here is JAX's staged
  QSGD, and the port's staged path draws the same uniforms through the
  key. The port's kernel path (its plain versions on the CPU) is held to
  its own ring in the collapse test.
* ``pipeline=2`` runs the whole schedule per segment under ``fold(p)``.
* The collapses: at ``slice_size=None`` and at ``world <= slice_size`` the
  schedule is the port's ring, bit for bit; for QSGD only once the ring's
  last encode key ``fold(W)`` is renamed ``fold(2W+1)``, the key the
  hierarchical schedule (in both packages) encodes its owned shard under.
"""

import dataclasses
import functools
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from grace_tpu_torch.core import LeafKey

N = 41                   # not a multiple of S: the shards are padded
TIMEOUT_S = 240
SPLITS = {4: (2,), 8: (2, 4)}

# codec -> (memory, input kind): "normal" inputs, or the integer lattice of
# a homoqsgd codec's quantum_num.
CODECS = {
    "none": ("none", "normal"),
    "fp16": ("none", "normal"),
    "randomk": ("none", "normal"),
    "homo7": ("residual", 7),
    "homo1p4": ("residual", 1),
    "sketch": ("none", 8),
    "signsgd_staged": ("residual", "normal"),
    "signsgd": ("residual", "normal"),
    "qsgd4_staged": ("none", "normal"),
    "qsgd4": ("none", "normal"),
    "topk": ("residual", "normal"),
}
PIPELINED = ("none", "signsgd", "qsgd4_staged", "homo7")
# Held against the JAX package (the kernel-path qsgd4 only against the
# port's ring).
JAX_CODECS = [c for c in CODECS if c != "qsgd4"]


def _codecs(world):
    # Packed 4-bit fields at q=1 sum exactly up to 7 ranks.
    return [c for c in CODECS if not (c == "homo1p4" and world > 7)]


def _hier(slice_size, region_size=None, pipeline=1, wan=None):
    return ("hier", slice_size, region_size, pipeline, wan)


def scenarios(world):
    """name -> (codec, communicator spec) of every scenario the world's
    workers run: the hier layouts compared with JAX, the collapses and
    their ring references, the three-level layouts of
    ``tests/test_torch_region.py`` (W=8), and the gate cases."""
    out = {}
    for c in _codecs(world):
        for s in SPLITS[world]:
            if c in JAX_CODECS:
                out[f"{c}/s{s}"] = (c, _hier(s))
            if c in PIPELINED:
                out[f"{c}/s{s}_p2"] = (c, _hier(s, pipeline=2))
        out[f"{c}/ring"] = (c, ("ring", 1))
        out[f"{c}/collapse_none"] = (c, _hier(None))
        out[f"{c}/collapse_wide"] = (c, _hier(2 * world))
    for c in ("qsgd4", "qsgd4_staged"):
        out[f"{c}/ring_refold"] = (c, ("ring_refold", 1))
    out["none/s3"] = ("none", _hier(3))               # does not divide W
    if world == 8:
        for c in REGION_CODECS:
            out[f"{c}/s2r4"] = (c, _hier(2, 4))
            out[f"{c}/s2r8"] = (c, _hier(2, 8))       # one region
        out["topk/s2r4_wan"] = ("topk", _hier(2, 4, wan="topk5"))
        out["fp16/s2r4_wan"] = ("fp16", _hier(2, 4, wan="topk5"))
        out["topk/s2r4_wanfp16"] = ("topk", _hier(2, 4, wan="fp16"))
    return out


REGION_CODECS = ("none", "fp16", "randomk", "homo7", "sketch", "signsgd",
                 "topk")


def inputs(world, codec):
    kind = CODECS[codec][1]
    rng = np.random.default_rng(100 + world)
    if kind == "normal":
        x = rng.standard_normal((world, N)).astype(np.float32)
        x[:, 3] = 0.0                     # a tied vote and a signed zero
        x[:, 4] = -0.0
        return x
    x = rng.integers(-kind, kind + 1, (world, N)).astype(np.float32)
    x[0, 0] = kind                        # max|x| is q: the scale is q
    return x


# -- the JAX package's draws, handed to the port through the key -------------

@dataclasses.dataclass(frozen=True)
class TableKey(LeafKey):
    """A key that carries the JAX package's draws for every fold path the
    ring and hier schedules reach, made in the parent so the workers need
    no JAX: ``seeds`` maps a fold path to the kernel seed JAX's QSGD draws
    under ``fold_in(key(0), *path)``, and ``perms`` maps ``(path, n)`` to
    ``jax.random.permutation`` of ``n`` under that key (randomk's
    indices), ``hashes`` maps ``(path, n)`` to the count sketch's
    ``(idx, signs)`` under it, and ``uniforms`` maps ``(path, n)`` to
    ``jax.random.uniform`` of shape ``(n,)`` under it (staged QSGD's
    noise; other draws fall back to the port's own). ``refold`` renames
    top-level folds (``fold(a)`` becomes ``fold(b)``) for the collapse
    test."""

    seeds: tuple = ()
    perms: tuple = ()
    hashes: tuple = ()
    uniforms: tuple = ()
    refold: tuple = ()

    def fold(self, i):
        if not self.folds:
            i = dict(self.refold).get(int(i), int(i))
        return super().fold(i)

    def seed_int32(self) -> int:
        return dict(self.seeds)[self.folds]

    def permutation(self, n, device):
        return torch.tensor(dict(self.perms)[(self.folds, n)],
                            dtype=torch.int64, device=device)

    def uniform(self, shape, device):
        u = dict(self.uniforms).get((self.folds, tuple(shape)))
        if u is None:
            return super().uniform(shape, device)
        return torch.tensor(u, dtype=torch.float32, device=device)


def _jax_key(folds=()):
    import jax
    k = jax.random.key(0)
    for f in folds:
        k = jax.random.fold_in(k, f)
    return k


def _fold_paths(world):
    """Every top-level fold a ring or hier schedule at ``world`` ranks
    reaches (shards, hops, boundaries: below 2W+3), alone and under a
    pipeline segment 0 or 1."""
    tops = range(2 * world + 3)
    return [(i,) for i in tops] + [(p, i) for p in (0, 1) for i in tops]


SKETCH = dict(compress_ratio=0.5, rows=3)


@functools.cache
def jax_tables(world):
    import jax
    import jax.numpy as jnp

    from grace_tpu import compressors as JC
    draw = jax.jit(lambda k: jax.random.randint(k, (), 0, 2**31 - 1,
                                                jnp.int32))
    seeds = tuple((path, int(draw(_jax_key(path))))
                  for path in _fold_paths(world))
    # randomk's shard sizes: N split S ways, for every S the scenarios use.
    sizes = sorted({-(-N // s) for s in (1, 2, 4, 8, world)})
    perms = tuple(((c,), n) for c in range(world) for n in sizes)
    sketch = JC.CountSketchCompressor(**SKETCH)
    hashes = tuple((key, tuple(tuple(np.asarray(a).ravel().tolist())
                               for a in sketch._hashes(_jax_key(key[0]),
                                                       key[1])))
                   for key in perms)
    perms = tuple((key, tuple(int(v) for v in np.asarray(
        jax.random.permutation(_jax_key(key[0]), key[1]))))
                  for key in perms)
    # Staged QSGD's shard and segment-shard lengths.
    lengths = sorted({-(-m // s) for m in (N, -(-N // 2), N // 2)
                      for s in (1, 2, 4, 8, world)})
    uniform = jax.jit(jax.random.uniform, static_argnums=1)
    uniforms = tuple(((path, (n,)), tuple(float(v) for v in np.asarray(
        uniform(_jax_key(path), (n,))))) for path in _fold_paths(world)
        for n in lengths)
    return seeds, perms, hashes, uniforms


# -- the port's side: spawned gloo ranks ------------------------------------

def _port_codec(name):
    from grace_tpu_torch import compressors as C

    @dataclasses.dataclass(frozen=True)
    class JaxHashSketch(C.CountSketchCompressor):
        """The count sketch with JAX's hashes, from the TableKey."""

        def _hashes(self, rng, numel, device):
            idx, signs = dict(rng.hashes)[(rng.folds, numel)]
            return (torch.tensor(idx).view(self.rows, numel).to(device),
                    torch.tensor(signs, dtype=torch.float32)
                    .view(self.rows, numel).to(device))

    return {"none": C.NoneCompressor(),
            "fp16": C.FP16Compressor(),
            "randomk": C.RandomKCompressor(compress_ratio=0.5),
            "homo7": C.HomoQSGDCompressor(quantum_num=7),
            "homo1p4": C.HomoQSGDCompressor(quantum_num=1, accum_bits=4,
                                            use_pallas=True),
            "sketch": JaxHashSketch(**SKETCH),
            "signsgd_staged": C.SignSGDCompressor(use_pallas=False),
            "signsgd": C.SignSGDCompressor(use_pallas=True),
            "qsgd4_staged": C.QSGDCompressor(quantum_num=7,
                                             use_pallas=False),
            "qsgd4": C.QSGDCompressor(quantum_num=7, use_pallas=True),
            "topk": C.TopKCompressor(compress_ratio=0.25, algorithm="chunk"),
            "topk5": C.TopKCompressor(compress_ratio=0.05)}[name]


def _port_triad(codec, spec):
    from grace_tpu_torch import comm
    from grace_tpu_torch import memories as M
    mem = {"none": M.NoneMemory(),
           "residual": M.ResidualMemory()}[CODECS[codec][0]]
    if spec[0] == "hier":
        _, s, rz, p, wan = spec
        cm = comm.HierarchicalAllreduce(
            slice_size=s, region_size=rz, pipeline=p,
            wan_compressor=None if wan is None else _port_codec(wan))
    else:
        cm = comm.RingAllreduce(pipeline=spec[1])
    return _port_codec(codec), mem, cm


def _worker(rank, world, init_file, out_path, tables):
    from grace_tpu_torch.parallel import init_process_group

    init_process_group("cpu", rank=rank, world_size=world,
                       init_method=f"file://{init_file}")
    seeds, perms, hashes, uniforms = tables
    torch.set_num_threads(1)
    try:
        out = {}
        for name, (codec, spec) in scenarios(world).items():
            x = torch.from_numpy(inputs(world, codec)[rank])
            comp, mem, cm = _port_triad(codec, spec)
            refold = (((world, 2 * world + 1),) if spec[0] == "ring_refold"
                      else ())
            key = TableKey(0, 0, 0, seeds=seeds, perms=perms,
                           hashes=hashes, uniforms=uniforms, refold=refold)
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
def port_results(world, tmp):
    out_path = f"{tmp}/w{world}_rank{{rank}}.npz"
    ctx = mp.start_processes(
        _worker, args=(world, f"{tmp}/store{world}", out_path,
                       jax_tables(world)),
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
    return str(tmp_path_factory.mktemp("hier"))


# -- the JAX package's side ---------------------------------------------------

def _jax_codec(name):
    from grace_tpu import compressors as JC
    return {"none": JC.NoneCompressor(),
            "fp16": JC.FP16Compressor(),
            "randomk": JC.RandomKCompressor(compress_ratio=0.5),
            "homo7": JC.HomoQSGDCompressor(quantum_num=7),
            # JAX's staged packed accumulate: its interpret-mode kernel
            # risks the deadlock above, and on levels within the field
            # both equal the port's (queue 3 of ROADMAP).
            "homo1p4": JC.HomoQSGDCompressor(quantum_num=1, accum_bits=4,
                                             use_pallas=False),
            "sketch": JC.CountSketchCompressor(**SKETCH),
            "signsgd_staged": JC.SignSGDCompressor(use_pallas=False),
            # The kernel scenario's reference is the staged vote: the fused
            # signSGD path equals it bit for bit by contract.
            "signsgd": JC.SignSGDCompressor(use_pallas=False),
            "qsgd4_staged": JC.QSGDCompressor(quantum_num=7,
                                              use_pallas=False),
            "topk": JC.TopKCompressor(compress_ratio=0.25,
                                      algorithm="chunk"),
            "topk5": JC.TopKCompressor(compress_ratio=0.05)}[name]


@functools.cache
def jax_results(codec, spec, world):
    """(out, mem) of every rank: the JAX hier step on a W-device submesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from grace_tpu import comm as jcomm
    from grace_tpu import memories as JM
    from grace_tpu.parallel import shard_map

    _, s, rz, p, wan = spec
    comp = _jax_codec(codec)
    mem = {"none": JM.NoneMemory(),
           "residual": JM.ResidualMemory()}[CODECS[codec][0]]
    cm = jcomm.HierarchicalAllreduce(
        slice_size=s, region_size=rz, pipeline=p,
        wan_compressor=None if wan is None else _jax_codec(wan))
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
    out, ms = fn(jnp.asarray(inputs(world, codec)))
    return np.asarray(out), np.asarray(ms)


def assert_bits(got, want, zero_sign=True):
    """Bit for bit; with ``zero_sign=False`` a -0.0 reads as +0.0 on both
    sides and every other bit is held."""
    got, want = np.asarray(got), np.asarray(want)
    if not zero_sign:
        got, want = got + np.float32(0), want + np.float32(0)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# Top-K keeps the compensated value at the lanes it does not select. On
# the first step JAX's residual state is a constant zero, and XLA folds
# ``1.0*zeros + 1.0*x`` into ``x``, which keeps a -0.0 input where the
# port's IEEE add gives +0.0; that zero's sign then reaches the residual
# and, once selected, the boundary sum (ROADMAP queue 3).
ZERO_SIGN_FREE = ("topk",)


def check_against_jax(port, world, name, bitwise=True):
    """Every rank's output (and residual) of scenario ``name`` against the
    JAX package's, bit for bit or within four ulps; and every rank ends
    with the same update."""
    codec, spec = scenarios(world)[name]
    want_out, want_mem = jax_results(codec, spec, world)
    sign = codec not in ZERO_SIGN_FREE
    for r in range(world):
        assert f"{name}/error" not in port[r], port[r].get(f"{name}/error")
        got = port[r][f"{name}/out"]
        if bitwise:
            assert_bits(got, want_out[r], sign)
        else:
            np.testing.assert_allclose(got, want_out[r], rtol=2**-21,
                                       atol=0)
        if f"{name}/mem" in port[r]:
            assert_bits(port[r][f"{name}/mem"], want_mem[r], sign)
        np.testing.assert_array_equal(got, port[0][f"{name}/out"])


def _layouts():
    return [(w, s) for w, splits in SPLITS.items() for s in splits]


BITWISE = [c for c in JAX_CODECS if c != "qsgd4_staged"]


@pytest.mark.parametrize(
    "world,s,codec", [(w, s, c) for w, s in _layouts() for c in BITWISE
                      if c in _codecs(w)])
def test_two_levels_match_jax_bit_for_bit(world, s, codec, port_tmp):
    check_against_jax(port_results(world, port_tmp), world, f"{codec}/s{s}")


@pytest.mark.parametrize("world,s", _layouts(), ids=lambda v: str(v))
def test_two_levels_qsgd4_within_four_ulps(world, s, port_tmp):
    """The port's staged QSGD draws JAX's uniforms at the stage-1 shard
    encodes, every hop requant (``fold(S+1+hop)``), the slice boundary
    (``fold(2S)``) and the owned shard's encode (``fold(2S+1)``), so both
    packages make the same roundings; the outputs differ only through the
    ulp or two that XLA's contracted decode moves a partial's norm. A lost
    level is off by 1/7 of its scale, a missing 1/W by half or more."""
    port = port_results(world, port_tmp)
    check_against_jax(port, world, f"qsgd4_staged/s{s}", bitwise=False)
    got = port[0][f"qsgd4_staged/s{s}/out"]
    assert (got != 0).sum() > N // 4
    assert np.abs(got - inputs(world, "qsgd4").mean(0)).max() > 0


@pytest.mark.parametrize("codec", PIPELINED)
@pytest.mark.parametrize("world,s", _layouts(), ids=lambda v: str(v))
def test_pipelined_two_levels_match_jax(world, s, codec, port_tmp):
    check_against_jax(port_results(world, port_tmp), world,
                      f"{codec}/s{s}_p2", bitwise=codec != "qsgd4_staged")


@pytest.mark.parametrize("world", sorted(SPLITS))
def test_collapses_to_the_ring_bit_for_bit(world, port_tmp):
    """One slice (``slice_size=None``, or a slice wider than the world) is
    the port's ring, every codec bit for bit, outputs and residuals. QSGD
    encodes its owned shard under ``fold(2S+1)`` where the ring uses
    ``fold(W)``: the ring given a key that renames that one fold equals
    it bit for bit, and the ring under its own key draws other
    roundings."""
    port = port_results(world, port_tmp)
    for codec in _codecs(world):
        ring = (f"{codec}/ring_refold" if codec.startswith("qsgd4")
                else f"{codec}/ring")
        for hier in (f"{codec}/collapse_none", f"{codec}/collapse_wide"):
            for r in range(world):
                for part in ("out", "mem"):
                    if f"{ring}/{part}" in port[r]:
                        assert_bits(port[r][f"{hier}/{part}"],
                                    port[r][f"{ring}/{part}"])
    for codec in ("qsgd4", "qsgd4_staged"):
        assert not np.array_equal(port[0][f"{codec}/collapse_none/out"],
                                  port[0][f"{codec}/ring/out"])


@pytest.mark.parametrize("world", sorted(SPLITS))
def test_exact_codecs_keep_the_mean(world, port_tmp):
    """On the lattice, homoqsgd's sums are exact at every split: the
    output is the mean (the sum times the float32 reciprocal of W), and
    the residual of the lossless encode is zero. randomk keeps half the
    lanes of every shard, each the mean of its lane within the
    summation order's rounding."""
    port = port_results(world, port_tmp)
    for s in SPLITS[world]:
        for codec in ("homo7", "homo1p4"):
            if codec not in _codecs(world):
                continue
            x = inputs(world, codec)
            mean = x.sum(0) * np.float32(1 / np.float32(world))
            np.testing.assert_array_equal(port[0][f"{codec}/s{s}/out"],
                                          mean)
            np.testing.assert_array_equal(port[0][f"{codec}/s{s}/mem"],
                                          np.zeros(N, np.float32))
        got = port[0][f"randomk/s{s}/out"]
        x = inputs(world, "randomk")
        m = -(-N // s)                    # shard length; k = m // 2 a shard
        assert N // 3 <= (got != 0).sum() <= s * (m // 2)
        np.testing.assert_allclose(got[got != 0], x.mean(0)[got != 0],
                                   rtol=1e-5, atol=1e-6)


def test_non_divisible_world_raises(port_tmp):
    """8 (and 4) ranks cannot form whole 3-wide slices: a ValueError at
    the step, as in JAX, and from the byte model."""
    from grace_tpu_torch import comm
    for world in sorted(SPLITS):
        err = str(port_results(world, port_tmp)[0]["none/s3/error"])
        assert err.startswith("ValueError") and "does not divide" in err
    with pytest.raises(ValueError, match="does not divide"):
        comm.HierarchicalAllreduce(slice_size=3).recv_wire_bytes(1000, 256, 8)


# -- the gates, in a one-rank gloo group -------------------------------------

@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


def test_hier_gates_raise_as_in_jax(group):
    from grace_tpu_torch import comm
    from grace_tpu_torch import compressors as C
    from grace_tpu_torch.core import Compressor
    from grace_tpu_torch.memories import NoneMemory

    @dataclasses.dataclass(frozen=True)
    class NoAlgebra(Compressor):          # neither an algebra nor requant
        def compress(self, x, state, rng):
            return (x,), None, state

        def decompress(self, payload, ctx):
            return payload[0]

    hier, x, key, mem = comm.HierarchicalAllreduce(slice_size=4), \
        torch.ones(16), LeafKey(0, 0, 0), NoneMemory()
    signum = C.SignumCompressor()
    with pytest.raises(TypeError, match="stateless"):
        hier.step(x, None, signum.init_state(x), mem, signum, key)
    with pytest.raises(TypeError, match="supports_hop_requant"):
        hier.step(x, None, None, mem, NoAlgebra(), key)
    with pytest.raises(TypeError, match="step"):
        comm.HierarchicalAllreduce().exchange((torch.zeros(4),), None,
                                              C.NoneCompressor())
    with pytest.raises(ValueError, match="pipeline"):
        comm.HierarchicalAllreduce(pipeline=0)
    with pytest.raises(ValueError, match="slice_size"):
        comm.HierarchicalAllreduce(slice_size=0)
    # One rank is one slice: Top-K rides the requant path, its own encode
    # twice.
    out, _, _ = hier.step(x, None, None, mem,
                          C.TopKCompressor(compress_ratio=0.5), key)
    assert out.shape == x.shape


def test_from_params_builds_hier_with_topology():
    from grace_tpu_torch import comm, grace_from_params
    from grace_tpu_torch.core import Topology
    g = grace_from_params({"compressor": "topk", "compress_ratio": 0.3,
                           "memory": "residual", "communicator": "hier",
                           "slice_size": 4})
    assert isinstance(g.communicator, comm.HierarchicalAllreduce)
    assert g.communicator.slice_size == 4
    assert g.communicator.shard_parallel
    assert g.topology == Topology(slice_size=4)
    g2 = grace_from_params({"compressor": "none", "communicator": "hier"})
    assert g2.communicator.slice_size is None and g2.topology is None
    for name in ("hierarchical", "hier_allreduce"):
        g3 = grace_from_params({"communicator": name, "slice_size": 2,
                                "region_size": 4, "pipeline": 2})
        assert g3.communicator == comm.HierarchicalAllreduce(
            slice_size=2, region_size=4, pipeline=2)
        assert g3.topology == Topology(slice_size=2, region_size=4)


def test_grouped_fusion_rejected():
    from grace_tpu_torch import grace_from_params
    with pytest.raises(ValueError, match="shard-parallel"):
        grace_from_params({"compressor": "topk", "compress_ratio": 0.3,
                           "memory": "residual", "communicator": "hier",
                           "slice_size": 4,
                           "fusion": "grouped"}).transform(seed=0)


def test_hier_rank_lists_match_jax_groups():
    """The subgroups the port builds are the JAX package's
    ``axis_index_groups``, list for list and member for member (which sets
    the order of every boundary sum)."""
    from grace_tpu_torch.comm import _hier_rank_lists
    for w, s, kr, r in ((8, 2, 4, 1), (8, 4, 2, 1), (8, 2, 2, 2),
                        (16, 2, 2, 4), (4, 2, 2, 1)):
        lists = _hier_rank_lists(w, s, kr, r)
        k = kr * r
        assert lists["intra"] == [[kk * s + ll for ll in range(s)]
                                  for kk in range(k)]
        for level in lists.values():       # each level partitions the world
            assert sorted(j for g in level for j in g) == list(range(w))
        if r == 1:
            assert lists["dcn"] == [[kk * s + ll for kk in range(k)]
                                    for ll in range(s)]
            assert "wan" not in lists
        else:
            assert all(len(g) == kr for g in lists["dcn"])
            assert all(len(g) == r for g in lists["wan"])
