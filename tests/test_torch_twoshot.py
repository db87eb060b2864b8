"""The port's two-shot all-reduce over real gloo groups of 2, 3 and 4 ranks,
against the JAX package's ``TwoShotAllreduce`` on a W-device submesh.

The port's ranks are processes spawned once per world size; each runs
every scenario below and saves its outputs. The JAX side runs
``Communicator.step`` inside ``shard_map`` on the first W devices of the
8-device CPU mesh. Every scenario is deterministic, so outputs and
residuals are held bit for bit:

* ``none`` and the half-precision downcast (``float16``, ``bfloat16``),
  whose payloads sum exactly; ``none`` also equals the dense mean;
* signSGD, whose two-shot vote equals the all-gather vote;
* exact Top-K + residual, with and without ``stage2_feedback``, on inputs
  without ties (``torch.topk`` and ``lax.top_k`` order ties differently).

One difference is allowed, and only at zeros: the sign of a zero that a
sum of signed zeros makes. XLA returns -0.0 for ``jnp.sum`` over rows of
-0.0 in one program and +0.0 once a decode is fused into the reduction
(the ``float16`` payloads); ``torch.sum`` starts from +0.0. Every nonzero
lane, and every zero's place, is held bit for bit.

The gates run in a one-rank gloo group and raise ``TypeError`` as in JAX.
"""

import dataclasses
import functools
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

N = 41                   # not a multiple of W: the chunks are padded
TIMEOUT_S = 180
WORLDS = [2, 3, 4]

# name -> (codec, memory, communicator), built in both packages.
SCENARIOS = {
    "none": ("none", "none", "twoshot"),
    "fp16": ("fp16", "none", "twoshot"),
    "fp16_residual": ("fp16", "residual", "twoshot"),
    "bf16_residual": ("bf16", "residual", "twoshot"),
    "signsgd": ("signsgd", "none", "twoshot"),
    "signsgd_residual": ("signsgd", "residual", "twoshot"),
    "signsgd_allgather": ("signsgd", "none", "allgather"),
    "topk_residual": ("topk", "residual", "twoshot"),
    "topk_residual_stage2": ("topk", "residual", "twoshot_stage2"),
    "topk_stage2_none": ("topk", "none", "twoshot_stage2"),
}
TWOSHOT = [s for s in SCENARIOS if SCENARIOS[s][2] != "allgather"]


def _inputs(world):
    rng = np.random.default_rng(100 + world)
    x = rng.standard_normal((world, N)).astype(np.float32)
    x[:, 3] = 0.0                         # a tied vote and a signed zero
    x[:, 4] = -0.0
    return x


def _port_triad(name):
    from grace_tpu_torch import comm
    from grace_tpu_torch import compressors as C
    from grace_tpu_torch import memories as M
    codec, memory, communicator = SCENARIOS[name]
    comp = {"none": C.NoneCompressor(),
            "fp16": C.FP16Compressor(dtype="float16"),
            "bf16": C.FP16Compressor(dtype="bfloat16"),
            "signsgd": C.SignSGDCompressor(),
            "topk": C.TopKCompressor(compress_ratio=0.3)}[codec]
    mem = {"none": M.NoneMemory(), "residual": M.ResidualMemory()}[memory]
    cm = {"twoshot": comm.TwoShotAllreduce(),
          "twoshot_stage2": comm.TwoShotAllreduce(stage2_feedback=True),
          "allgather": comm.Allgather()}[communicator]
    return comp, mem, cm


def _worker(rank, world, init_file, x_path, out_path):
    from grace_tpu_torch.core import LeafKey
    from grace_tpu_torch.parallel import init_process_group

    init_process_group("cpu", rank=rank, world_size=world,
                       init_method=f"file://{init_file}")
    try:
        x = torch.from_numpy(np.load(x_path)[rank])
        out = {}
        for name in SCENARIOS:
            comp, mem, cm = _port_triad(name)
            o, ms, _ = cm.step(x.clone(), mem.init_state(x), None, mem, comp,
                               LeafKey(0, 0, 0))
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
        _worker, args=(world, f"{tmp}/store{world}", x_path, out_path),
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
    return str(tmp_path_factory.mktemp("twoshot"))


def _jax_triad(name):
    from grace_tpu import comm
    from grace_tpu import compressors as C
    from grace_tpu import memories as M
    codec, memory, communicator = SCENARIOS[name]
    comp = {"none": C.NoneCompressor(),
            "fp16": C.FP16Compressor(dtype="float16"),
            "bf16": C.FP16Compressor(dtype="bfloat16"),
            "signsgd": C.SignSGDCompressor(),
            "topk": C.TopKCompressor(compress_ratio=0.3)}[codec]
    mem = {"none": M.NoneMemory(), "residual": M.ResidualMemory()}[memory]
    cm = {"twoshot": comm.TwoShotAllreduce(),
          "twoshot_stage2": comm.TwoShotAllreduce(stage2_feedback=True),
          "allgather": comm.Allgather()}[communicator]
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


def _bits(a):
    """The float32 bits of ``a``, with -0.0 read as +0.0."""
    return np.where(a == 0, np.float32(0), a).view(np.int32)


def _owned(world, rank):
    """The lanes of the chunk that ``rank`` owns."""
    m = -(-N // world)
    own = np.zeros(N, bool)
    own[rank * m:(rank + 1) * m] = True
    return own


@pytest.mark.parametrize("name", list(SCENARIOS))
@pytest.mark.parametrize("world", WORLDS)
def test_twoshot_matches_jax_bit_for_bit(world, name, port_tmp):
    """Outputs and residuals bit for bit. One exception, held exactly by
    ``test_stage2_error_is_xla_contracted_at_three_ranks``: at W=3 the
    owner's stage-2 error under ``stage2_feedback``, where XLA contracts
    the mean and the subtraction into one FMA."""
    port = _port_results(world, port_tmp)
    want_out, want_mem = _jax_results(name, world)
    for r in range(world):
        np.testing.assert_array_equal(_bits(port[r][f"{name}/out"]),
                                      _bits(want_out[r]))
        if f"{name}/mem" in port[r]:
            lanes = np.ones(N, bool)
            if name == "topk_residual_stage2" and world == 3:
                lanes = ~_owned(world, r)
            np.testing.assert_array_equal(
                _bits(port[r][f"{name}/mem"])[lanes],
                _bits(want_mem[r])[lanes])
        # The exchange is global: every rank ends with the same update.
        np.testing.assert_array_equal(port[r][f"{name}/out"],
                                      port[0][f"{name}/out"])


def test_stage2_error_is_xla_contracted_at_three_ranks(port_tmp):
    """The stage-2 error is ``e2 = agg·mean_scale(W) − decode2``, then
    ``×W``. The port rounds the mean and the difference apart, as JAX does
    eagerly; jitted on the CPU, XLA fuses them into one FMA. At W=2 and 4
    the mean is exact and the two agree (above); at W=3 each side is
    rebuilt here from the aggregate (the stage-1 reconstructions, read off
    the residuals without stage-2 feedback) and the gathered output, and
    held bit for bit: the port with two roundings, JAX with one."""
    world = 3
    x = _inputs(world)
    port = _port_results(world, port_tmp)
    _, want_mem = _jax_results("topk_residual_stage2", world)
    recon = [x[r] - port[r]["topk_residual/mem"] for r in range(world)]
    total = recon[0] + recon[1] + recon[2]
    scale = np.float32(np.float32(1) / np.float32(world))
    dec2 = port[0]["topk_residual/out"]
    two = total * scale - dec2
    one = (total.astype(np.float64) * np.float64(scale)
           - dec2.astype(np.float64)).astype(np.float32)       # one rounding
    assert (two != one).any()
    for r in range(world):
        own = _owned(world, r)
        for e2, got in ((two, port[r]["topk_residual_stage2/mem"]),
                        (one, want_mem[r])):
            want = x[r] - (recon[r] - e2 * np.float32(world))
            np.testing.assert_array_equal(_bits(got)[own], _bits(want)[own])


@pytest.mark.parametrize("world", WORLDS)
def test_none_equals_the_dense_mean(world, port_tmp):
    """Each owner sums its chunk's W payloads in rank order and multiplies
    by the float32 reciprocal of W: the dense mean as the JAX package's
    jitted ``x.sum(0) / W`` computes it."""
    x = _inputs(world)
    total = x[0].copy()
    for r in range(1, world):
        total = total + x[r]
    want = total * np.float32(np.float32(1) / np.float32(world))
    port = _port_results(world, port_tmp)
    np.testing.assert_array_equal(_bits(port[0]["none/out"]), _bits(want))
    np.testing.assert_allclose(port[0]["none/out"], x.mean(0), rtol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_signsgd_vote_equals_the_allgather_vote(world, port_tmp):
    """The vote is element-wise and a ±1 vote re-encodes losslessly, so the
    two-shot vote is the all-gather vote bit for bit, and a majority."""
    port = _port_results(world, port_tmp)
    x = _inputs(world)
    vote = np.where(np.where(x >= 0, 1.0, -1.0).sum(0) >= 0, 1.0, -1.0)
    for r in range(world):
        np.testing.assert_array_equal(
            port[r]["signsgd/out"].view(np.int32),
            port[r]["signsgd_allgather/out"].view(np.int32))
        np.testing.assert_array_equal(port[r]["signsgd/out"], vote)


@pytest.mark.parametrize("world", WORLDS)
def test_topk_stage2_feedback_keeps_the_owner_error(world, port_tmp):
    """Without stage-2 feedback the residual is the stage-1 error alone
    (every lane 0 or the input); with it, the owner's chunk also carries
    the stage-2 error, and the other chunks are as without it."""
    port = _port_results(world, port_tmp)
    x = _inputs(world)
    for r in range(world):
        plain = port[r]["topk_residual/mem"]
        kept = plain != x[r]
        np.testing.assert_array_equal(plain[kept], 0)
        fed = port[r]["topk_residual_stage2/mem"]
        own = _owned(world, r)
        np.testing.assert_array_equal(fed[~own], plain[~own])
        assert (fed[own] != plain[own]).any()


# -- the gates, in a one-rank gloo group -------------------------------------

@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


def test_twoshot_gates_raise_as_in_jax(group):
    from grace_tpu_torch import comm, grace_from_params
    from grace_tpu_torch.compressors import (NoneCompressor, SignumCompressor,
                                             TopKCompressor)
    from grace_tpu_torch.core import Compressor, LeafKey, Memory
    from grace_tpu_torch.memories import NoneMemory, ResidualMemory

    @dataclasses.dataclass(frozen=True)
    class NormInCtx(NoneCompressor):      # data in ctx
        def compress(self, x, state, rng):
            norm = torch.linalg.vector_norm(x).clamp_min(1e-12)
            return (x / norm,), {"norm": norm}, state

        def decompress(self, payload, ctx):
            return payload[0] * ctx["norm"]

    @dataclasses.dataclass(frozen=True)
    class NoPayload(Compressor):          # communicates inside compress
        def compress(self, x, state, rng):
            return (), None, state

    @dataclasses.dataclass(frozen=True)
    class KeepMask(Memory):               # update is not compensated − dec
        def init_state(self, x):
            return torch.zeros_like(x)

        def update(self, compensated, payload, ctx, compressor, state):
            return torch.where(compressor.decompress(payload, ctx) == 0,
                               compensated, torch.zeros_like(compensated))

    two, x, key = comm.TwoShotAllreduce(), torch.ones(16), LeafKey(0, 0, 0)
    signum = SignumCompressor()
    with pytest.raises(TypeError, match="requires a stateless compressor"):
        two.step(x, None, signum.init_state(x), NoneMemory(), signum, key)
    with pytest.raises(TypeError, match="requires a data-free ctx"):
        two.step(x, None, None, NoneMemory(), NormInCtx(), key)
    with pytest.raises(TypeError, match="needs a wire payload to scatter"):
        two.step(x, None, None, NoneMemory(), NoPayload(), key)
    with pytest.raises(TypeError, match="only supports the full step"):
        two.exchange((x,), None, NoneCompressor())
    fed = comm.TwoShotAllreduce(stage2_feedback=True)
    with pytest.raises(TypeError, match="stage2_feedback"):
        fed.step(x, torch.zeros(16), None, KeepMask(), NoneCompressor(), key)
    # Residual and no memory pass the stage-2 gate; at W=1 the exact
    # codec's two shots are the identity.
    for mem in (ResidualMemory(), NoneMemory()):
        out, _, _ = fed.step(x, mem.init_state(x), None, mem,
                             TopKCompressor(compress_ratio=1.0), key)
        np.testing.assert_array_equal(out.numpy(), x.numpy())
    for name in ("twoshot", "twoshot_allreduce"):
        g = grace_from_params({"compressor": "topk", "compress_ratio": 0.3,
                               "memory": "residual", "communicator": name,
                               "stage2_feedback": True}, group=group)
        assert g.communicator == comm.TwoShotAllreduce(group=group,
                                                       stage2_feedback=True)
    g = grace_from_params({"compressor": "bf16", "communicator": "twoshot"})
    assert g.communicator == comm.TwoShotAllreduce()


def test_jax_gates_use_the_same_words(mesh):
    """The JAX package raises the same errors, in the words the port's
    gates are matched against above."""
    import jax.numpy as jnp

    from grace_tpu import comm as jcomm
    from grace_tpu import compressors as jC
    from grace_tpu.memories import DgcMemory, NoneMemory
    from grace_tpu.parallel import shard_map
    from jax.sharding import PartitionSpec as P

    def run(comp, mem, cm):
        def body(x):
            x = x[0]
            out, _, _ = cm.step(x, mem.init_state(x), comp.init_state(x),
                                mem, comp, __import__("jax").random.key(0))
            return out[None]
        fn = shard_map(body, mesh=mesh, in_specs=P("data"),
                       out_specs=P("data"), check_vma=False)
        return fn(jnp.ones((8, 16), jnp.float32))

    with pytest.raises(TypeError, match="requires a stateless compressor"):
        run(jC.SignumCompressor(), NoneMemory(), jcomm.TwoShotAllreduce())
    with pytest.raises(TypeError, match="only supports the full step"):
        jcomm.TwoShotAllreduce().exchange((jnp.ones(3),), None,
                                          jC.NoneCompressor())
    with pytest.raises(TypeError, match="stage2_feedback"):
        run(jC.TopKCompressor(compress_ratio=0.3), DgcMemory(),
            jcomm.TwoShotAllreduce(stage2_feedback=True))
