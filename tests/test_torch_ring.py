"""The port's ring, sign-vote and vote-routing communicators over real gloo
groups of 2 and 4 ranks, against the JAX package's on a W-device submesh.

The port's ranks are processes spawned once per world size; each runs
every scenario below and saves its outputs. The JAX side runs
``Communicator.step`` inside ``shard_map`` on the first W devices of the
8-device CPU mesh (as ``tests/test_ring.py`` builds its submeshes). JAX is
imported inside the JAX helpers only, so the workers stay light.

* ``none`` + ring (the exact path) and signSGD + ring (the requant path,
  a cascaded vote) are deterministic: bit for bit, outputs and residuals,
  with ``pipeline`` 1 and 2.
* ``SignAllreduce`` and the ``Allreduce`` vote routing: bit for bit.
* QSGD 4-bit + ring, with ``pipeline`` 1 and 2: the port's kernels are
  seeded with the JAX package's own draws, so both rings make the same
  roundings; the outputs agree within four ulps, relative.
"""

import dataclasses
import functools
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from grace_tpu_torch.core import LeafKey

N = 41                   # not a multiple of W: the shards are padded
TIMEOUT_S = 180

# name -> (codec, memory, communicator, pipeline), built in both packages.
SCENARIOS = {
    "none_ring": ("none", "none", "ring", 1),
    "none_ring_p2": ("none", "none", "ring", 2),
    "signsgd_ring": ("signsgd_staged", "residual", "ring", 1),
    "signsgd_ring_kernels": ("signsgd", "residual", "ring", 1),
    "signsgd_ring_p2": ("signsgd", "residual", "ring", 2),
    "sign_allreduce": ("signsgd", "residual", "sign_allreduce", 1),
    "allreduce_vote": ("signsgd", "residual", "allreduce", 1),
    "qsgd4_ring": ("qsgd4", "none", "ring", 1),
    "qsgd4_ring_p2": ("qsgd4", "none", "ring", 2),
}
EXACT = [s for s in SCENARIOS if not s.startswith("qsgd4")]


def _inputs(world):
    rng = np.random.default_rng(world)
    x = rng.standard_normal((world, N)).astype(np.float32)
    x[:, 3] = 0.0                         # a tied vote and a signed zero
    x[:, 4] = -0.0
    return x


@dataclasses.dataclass(frozen=True)
class _SeedTableKey(LeafKey):
    """A key whose kernel seeds are the JAX package's: ``seeds`` maps a fold
    path ``(i, j, ...)`` to ``jax.random.randint(fold_in(fold_in(key(0), i),
    j ...), (), 0, 2**31 - 1, int32)``, the seed JAX's QSGD draws under that
    key. The table is made in the parent (:func:`_jax_seed_table`), so the
    workers need no JAX."""

    seeds: tuple = ()

    def seed_int32(self) -> int:
        return dict(self.seeds)[self.folds]


@functools.cache
def _jax_seed_table(world):
    """Every fold path a ring at ``world`` ranks reaches, with ``pipeline``
    1 (one fold: shard, hop, owner) or 2 (the segment, then those)."""
    import jax
    import jax.numpy as jnp
    draw = jax.jit(lambda k: jax.random.randint(k, (), 0, 2**31 - 1,
                                                jnp.int32))
    root, seeds = jax.random.key(0), []
    for i in range(2 * world):
        k = jax.random.fold_in(root, i)
        seeds.append(((i,), int(draw(k))))
        seeds += [((i, j), int(draw(jax.random.fold_in(k, j))))
                  for j in range(2 * world)]
    return tuple(seeds)


def _port_triad(name):
    from grace_tpu_torch import comm
    from grace_tpu_torch import compressors as C
    from grace_tpu_torch import memories as M
    codec, memory, communicator, pipeline = SCENARIOS[name]
    comp = {"none": C.NoneCompressor(),
            "signsgd_staged": C.SignSGDCompressor(use_pallas=False),
            "signsgd": C.SignSGDCompressor(use_pallas=True),
            "qsgd4": C.QSGDCompressor(quantum_num=7, use_pallas=True)}[codec]
    mem = {"none": M.NoneMemory(), "residual": M.ResidualMemory()}[memory]
    cm = {"ring": comm.RingAllreduce(pipeline=pipeline),
          "sign_allreduce": comm.SignAllreduce(),
          "allreduce": comm.Allreduce()}[communicator]
    return comp, mem, cm


def _worker(rank, world, init_file, x_path, out_path, seeds):
    from grace_tpu_torch.parallel import init_process_group

    init_process_group("cpu", rank=rank, world_size=world,
                       init_method=f"file://{init_file}")
    try:
        x = torch.from_numpy(np.load(x_path)[rank])
        out = {}
        for name in SCENARIOS:
            comp, mem, cm = _port_triad(name)
            o, ms, _ = cm.step(x.clone(), mem.init_state(x), None, mem, comp,
                               _SeedTableKey(0, 0, 0, seeds=seeds))
            out[f"{name}/out"] = o.numpy()
            if ms is not None:
                out[f"{name}/mem"] = ms.numpy()
        np.savez(out_path.format(rank=rank), **out)
    finally:
        torch.distributed.destroy_process_group()


@functools.cache
def _port_results(world, tmp):
    x_path = f"{tmp}/x{world}.npy"
    np.save(x_path, _inputs(world))
    out_path = f"{tmp}/w{world}_rank{{rank}}.npz"
    ctx = mp.start_processes(
        _worker, args=(world, f"{tmp}/store{world}", x_path, out_path,
                       _jax_seed_table(world)),
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
    return str(tmp_path_factory.mktemp("ring"))


def _jax_triad(name):
    from grace_tpu import comm
    from grace_tpu import compressors as C
    from grace_tpu import memories as M
    codec, memory, communicator, pipeline = SCENARIOS[name]
    comp = {"none": C.NoneCompressor(),
            "signsgd_staged": C.SignSGDCompressor(use_pallas=False),
            "signsgd": C.SignSGDCompressor(use_pallas=False),
            "qsgd4": C.QSGDCompressor(quantum_num=7, use_pallas=True)}[codec]
    mem = {"none": M.NoneMemory(), "residual": M.ResidualMemory()}[memory]
    cm = {"ring": comm.RingAllreduce(pipeline=pipeline),
          "sign_allreduce": comm.SignAllreduce(),
          "allreduce": comm.Allreduce()}[communicator]
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
    out, ms = fn(jnp.asarray(_inputs(world)))
    return np.asarray(out), np.asarray(ms)


@pytest.mark.parametrize("name", EXACT)
@pytest.mark.parametrize("world", [2, 4])
def test_deterministic_exchanges_match_jax_bit_for_bit(world, name, port_tmp):
    port = _port_results(world, port_tmp)
    want_out, want_mem = _jax_results(name, world)
    for r in range(world):
        np.testing.assert_array_equal(port[r][f"{name}/out"].view(np.int32),
                                      want_out[r].view(np.int32))
        if f"{name}/mem" in port[r]:
            np.testing.assert_array_equal(
                port[r][f"{name}/mem"].view(np.int32),
                want_mem[r].view(np.int32))
        # The exchange is global: every rank ends with the same update.
        np.testing.assert_array_equal(port[r][f"{name}/out"],
                                      port[0][f"{name}/out"])


@pytest.mark.parametrize("world", [2, 4])
def test_vote_outputs_are_a_majority(world, port_tmp):
    port = _port_results(world, port_tmp)
    x = _inputs(world)
    vote = np.where((np.where(x >= 0, 1.0, -1.0)).sum(0) >= 0, 1.0, -1.0)
    for name in ("sign_allreduce", "allreduce_vote"):
        np.testing.assert_array_equal(port[0][f"{name}/out"], vote)


@pytest.mark.parametrize("name", ["qsgd4_ring", "qsgd4_ring_p2"])
@pytest.mark.parametrize("world", [2, 4])
def test_qsgd4_ring_within_the_quantization_bound(world, name, port_tmp):
    """The port's kernels hash the JAX package's seeds (``_SeedTableKey``),
    so the two rings draw the same roundings at the stage-1 shard encode,
    every hop requant (``fold(W+1+s)``) and the owner's re-encode
    (``fold(W)``): they agree on every level, and the outputs differ only
    through the norms that scale the levels. The JAX interpret-mode
    ``decode_accumulate`` contracts its multiply-adds (one rounding a hop,
    ``tests/test_torch_wire.py``), which moves a partial's norm by an ulp
    or two; so each element is held within 2**-21 (four ulps) of JAX's,
    relative, and a zero stays an exact zero. A lost level is off by 1/7
    of its scale, a missing 1/W average by half or more."""
    x = _inputs(world)
    port = _port_results(world, port_tmp)
    want, _ = _jax_results(name, world)
    for r in range(world):
        got = port[r][f"{name}/out"]
        np.testing.assert_allclose(got, want[r], rtol=2**-21, atol=0)
        np.testing.assert_array_equal(got, port[0][f"{name}/out"])
    # The roundings are not the identity, and not all zero.
    assert (port[0][f"{name}/out"] != 0).sum() > N // 4
    assert np.abs(port[0][f"{name}/out"] - x.mean(0)).max() > 0


def test_pipeline_segments_partition_exactly():
    from grace_tpu.comm import _pipeline_segments as jax_segments
    from grace_tpu_torch.comm import _pipeline_segments
    for n in (1, 2, 5, 41, 1000, 1001):
        for p in (1, 2, 3, 7, 64):
            segs = _pipeline_segments(n, p)
            assert segs == jax_segments(n, p)
            assert segs[0][0] == 0 and segs[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))


# -- the gates, in a one-rank gloo group -------------------------------------

@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


def _gate_codecs():
    from grace_tpu_torch.core import Compressor

    @dataclasses.dataclass(frozen=True)
    class NoAlgebra(Compressor):          # neither an algebra nor requant
        def compress(self, x, state, rng):
            return (x,), None, state

        def decompress(self, payload, ctx):
            return payload[0]

    @dataclasses.dataclass(frozen=True)
    class NoPayload(NoAlgebra):
        supports_hop_requant = True

        def compress(self, x, state, rng):
            return (), None, state

    @dataclasses.dataclass(frozen=True)
    class TensorCtx(NoAlgebra):
        supports_hop_requant = True

        def compress(self, x, state, rng):
            return (x,), torch.linalg.vector_norm(x), state

    @dataclasses.dataclass(frozen=True)
    class SharedScale(NoAlgebra):
        payload_algebra = "shared_scale"

        def payload_sum_max_world(self):
            return 0                      # no world sums exactly

    return NoAlgebra(), NoPayload(), TensorCtx(), SharedScale()


def test_ring_gates_raise_as_in_jax(group):
    from grace_tpu_torch import comm
    from grace_tpu_torch.compressors import (SignumCompressor,
                                             TopKCompressor)
    from grace_tpu_torch.core import LeafKey
    from grace_tpu_torch.memories import NoneMemory
    ring, x, key, mem = comm.RingAllreduce(), torch.ones(10), \
        LeafKey(0, 0, 0), NoneMemory()
    signum = SignumCompressor()
    with pytest.raises(TypeError, match="stateless"):
        ring.step(x, None, signum.init_state(x), mem, signum, key)
    no_algebra, no_payload, tensor_ctx, shared = _gate_codecs()
    with pytest.raises(TypeError, match="neither"):
        ring.step(x, None, None, mem, no_algebra, key)
    with pytest.raises(TypeError, match="wire payload"):
        ring.step(x, None, None, mem, no_payload, key)
    with pytest.raises(TypeError, match="data-free ctx"):
        ring.step(x, None, None, mem, tensor_ctx, key)
    with pytest.raises(ValueError, match="payload_sum_max_world"):
        ring.step(x, None, None, mem, shared, key)
    with pytest.raises(ValueError, match="pipeline"):
        comm.RingAllreduce(pipeline=0)
    with pytest.raises(TypeError, match="step"):
        ring.exchange((x,), None, no_algebra)
    # Top-K rides the requant path: at W=1 it is its own encode, twice.
    out, _, _ = ring.step(x, None, None, mem,
                          TopKCompressor(compress_ratio=0.5), key)
    assert out.shape == x.shape


def test_vote_gates_raise_as_in_jax(group):
    from grace_tpu_torch import comm
    from grace_tpu_torch.compressors import NoneCompressor, SignSGDCompressor
    from grace_tpu_torch.core import LeafKey
    assert comm.vote_exact_max_world("bfloat16") == 256
    assert comm.vote_exact_max_world("float16") == 2048
    assert comm.vote_exact_max_world("float32") == 2**24
    with pytest.raises(TypeError):
        comm.vote_exact_max_world("int32")
    with pytest.raises(TypeError, match="vote_aggregate"):
        comm.SignAllreduce().exchange((torch.ones(3),), None,
                                      NoneCompressor())
    sc = SignSGDCompressor()
    x = torch.tensor([1.0, -2.0, 0.0, -0.0])
    payload, ctx, _ = sc.compress(x, None, LeafKey(0, 0, 0))
    for cm in (comm.SignAllreduce(), comm.Allreduce(),
               comm.SignAllreduce(vote_dtype="float32")):
        np.testing.assert_array_equal(cm.exchange(payload, ctx, sc).numpy(),
                                      [1.0, -1.0, 1.0, 1.0])

