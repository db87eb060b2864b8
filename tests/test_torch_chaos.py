"""The port's fault injectors against the JAX package's, on the CPU.

The injectors draw from the port's ``LeafKey`` streams where JAX draws
threefry bits, so faults placed by a probability below 1 land elsewhere
(ROADMAP queue 3); every comparison with JAX here uses faults that are
certain (probability 1) or placed by ``ChaosParams``, whose numpy draws are
JAX's, and holds the rest to the same properties JAX's tests hold.

* Four gloo ranks against JAX's four-device mesh: a NaN implanted in rank
  3's gradient on every step (``ChaosCommunicator``) skips every step on
  every rank, with JAX's guard counters, and leaves the parameters and
  every rank's residuals as they were; ``ChaosCompressor`` gated to rank 2
  drifts only rank 2's payload, and the aggregate equals JAX's bit for bit.
* At one rank against JAX: K=3 consecutive bad steps open the dense window
  for M=4 steps, compression re-arms, and the faults bite again, on JAX's
  steps.
* Determinism, the implant and bit-flip primitives, the stale residual
  (with the chunk kernel's in-place residual write forced on the CPU), the
  payload bit flip, the shared-scale drift on the quantization lattice,
  the delegated codec contract, and the staged path: a ``ChaosCompressor``
  pipeline calls no chunk Top-K kernel wrapper, where the bare one does.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh, PartitionSpec as P

from grace_tpu import grace_from_params as jax_grace_from_params
from grace_tpu.comm import Allgather as JaxAllgather
from grace_tpu.compressors import NoneCompressor as JaxNoneCompressor
from grace_tpu.memories import NoneMemory as JaxNoneMemory
from grace_tpu.parallel import shard_map
from grace_tpu.resilience import ChaosCommunicator as JaxChaosCommunicator
from grace_tpu.resilience import ChaosCompressor as JaxChaosCompressor
from grace_tpu.resilience import guarded_chain as jax_guarded_chain

from grace_tpu_torch import grace_from_params
from grace_tpu_torch.comm import Allgather, RingAllreduce
from grace_tpu_torch.compressors import (HomoQSGDCompressor, NoneCompressor,
                                         TopKCompressor)
from grace_tpu_torch.core import LeafKey
from grace_tpu_torch.memories import NoneMemory, ResidualMemory
from grace_tpu_torch.ops import chunk_topk
from grace_tpu_torch.resilience import (ChaosCommunicator, ChaosCompressor,
                                        guarded_chain)
from grace_tpu_torch.resilience.chaos import _flip_one_bit, _implant
from grace_tpu_torch.utils.metrics import guard_report

WORLD = 4
STEPS = 5
TIMEOUT_S = 240
SHAPES = {"h1": (12, 12), "b1": (12,), "w": (12, 3), "b": (3,)}
TOPK_EF = {"compressor": "topk", "compress_ratio": 0.3,
           "topk_algorithm": "chunk", "memory": "residual",
           "communicator": "allgather", "escape": "fp16"}
DRIFT_IN = np.linspace(-1, 1, WORLD * 32, dtype=np.float32).reshape(WORLD,
                                                                     32)


def make_grads(steps, seed=0):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal((WORLD, steps) + s) * 0.5).astype(
        np.float32) for n, s in SHAPES.items()}


def make_params(seed=1):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for n, s in SHAPES.items()}


def _jax_chaos_grace(cfg, **chaos):
    grc = jax_grace_from_params(cfg)
    return dataclasses.replace(grc, communicator=JaxChaosCommunicator(
        inner=grc.communicator, **chaos))


def _port_chaos_grace(cfg, group, **chaos):
    grc = grace_from_params(cfg, group=group)
    return dataclasses.replace(grc, communicator=ChaosCommunicator(
        inner=grc.communicator, **chaos))


def run_jax(grace, grads, world, steps, guard_kw):
    """JAX's guarded chain on a ``world``-device submesh: per step, the
    guard's counters, the fallback flag, every rank's parameters and
    residuals."""
    tx = jax_guarded_chain(grace, optax.sgd(0.25), seed=1, **guard_kw)
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    params0 = {n: jnp.asarray(a) for n, a in make_params().items()}

    def one(carry, g):
        p, st = carry
        u, st = tx.update(g, st, p)
        p = optax.apply_updates(p, u)
        return (p, st), {"counters": jnp.stack([
            st.notfinite_count, st.last_bad_step, st.consecutive,
            st.fallback_remaining, st.step]),
            "fallback": jnp.asarray(st.inner[0].fallback),
            "params": p, "mem": st.inner[0].mem}

    def body(g):
        g = jax.tree.map(lambda a: a[0, :steps], g)
        _, outs = jax.lax.scan(one, (params0, tx.init(params0)), g)
        return jax.tree.map(lambda a: a[None], outs)

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),),
                           out_specs=P("data"), check_vma=False))
    out = jax.tree.map(np.asarray, fn({n: jnp.asarray(a[:world])
                                       for n, a in grads.items()}))
    # (world, steps, ...) -> a record a step, each (world, ...)
    return [jax.tree.map(lambda a: a[:, s], out) for s in range(steps)]


def run_port(grace, grads, rank, steps, guard_kw):
    chain = guarded_chain(grace, seed=1, **guard_kw)
    ps = {n: torch.nn.Parameter(torch.from_numpy(a))
          for n, a in make_params().items()}
    opt = torch.optim.SGD(ps.values(), lr=0.25)
    st = chain.init(ps)
    outs = []
    for s in range(steps):
        st = chain.apply(ps, {n: torch.from_numpy(a[rank, s].copy())
                              for n, a in grads.items()}, st, opt)
        outs.append({"counters": st.counters().numpy().copy(),
                     "fallback": st.inner.fallback,
                     "params": {n: p.detach().numpy().copy()
                                for n, p in ps.items()},
                     "mem": [m.numpy().copy() for m in st.inner.mem]})
    return outs


def _drift_out(comp, group, rank):
    """Allgather's mean of a NoneCompressor payload, ``comp`` wrapping it."""
    x = torch.from_numpy(DRIFT_IN[rank].copy())
    out, _, _ = Allgather(group=group).step(x, None, None, NoneMemory(),
                                            comp, LeafKey(5, 0, 0))
    return out.numpy()


def _worker(rank, init_file, grads_path, out_path):
    from grace_tpu_torch.parallel import init_process_group

    group, _ = init_process_group("cpu", rank=rank, world_size=WORLD,
                                  init_method=f"file://{init_file}")
    try:
        with np.load(grads_path) as data:
            grads = {n: data[n] for n in data.files}
        outs = run_port(_port_chaos_grace(TOPK_EF, group, nan_prob=1.0,
                                          rank=3, seed=7),
                        grads, rank, STEPS, {})
        out = {f"{s}/{k}": v for s, o in enumerate(outs)
               for k, v in (("counters", o["counters"]),
                            *((f"param/{n}", a)
                              for n, a in o["params"].items()),
                            *((f"mem/{i}", m)
                              for i, m in enumerate(o["mem"])))}
        out["drift"] = _drift_out(ChaosCompressor(
            inner=NoneCompressor(), drift_scale=0.5, rank=2, group=group),
            group, rank)
        np.savez(out_path.format(rank=rank), **out)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chaos")
    grads = make_grads(STEPS, seed=3)
    np.savez(tmp / "grads.npz", **grads)
    ctx = mp.start_processes(
        _worker, args=(str(tmp / "store"), str(tmp / "grads.npz"),
                       str(tmp / "rank{rank}.npz")),
        nprocs=WORLD, join=False, start_method="spawn")
    ref = run_jax(_jax_chaos_grace(TOPK_EF, nan_prob=1.0, rank=3, seed=7),
                  grads, WORLD, STEPS, {})

    def drift_body(gg):
        comp = JaxChaosCompressor(inner=JaxNoneCompressor(), drift_scale=0.5,
                                  rank=2)
        out, _, _ = JaxAllgather().step(gg[0], None, None, JaxNoneMemory(),
                                        comp, jax.random.key(5))
        return out[None]

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    drift = np.asarray(shard_map(drift_body, mesh=mesh, in_specs=P("data"),
                                 out_specs=P("data"), check_vma=False)(
        jnp.asarray(DRIFT_IN)))
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"four-rank gloo run did not finish in {TIMEOUT_S} s")
    port = []
    for r in range(WORLD):
        with np.load(tmp / f"rank{r}.npz") as data:
            port.append({k: data[k] for k in data.files})
    return port, ref, drift, grads


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def test_single_rank_nan_freezes_every_rank(four_ranks):
    port, ref, _, _ = four_ranks
    params0 = make_params()
    for s in range(STEPS):
        for r in range(WORLD):
            np.testing.assert_array_equal(port[r][f"{s}/counters"],
                                          ref[s]["counters"][r])
            for n in SHAPES:
                np.testing.assert_array_equal(
                    _bits(port[r][f"{s}/param/{n}"]), _bits(params0[n]))
            for i in range(len(SHAPES)):
                assert not port[r][f"{s}/mem/{i}"].any()
    assert ref[-1]["counters"][0].tolist() == [STEPS, STEPS - 1, STEPS, 0,
                                               STEPS]


def test_drift_is_gated_to_its_rank(four_ranks):
    port, _, drift, _ = four_ranks
    scaled = DRIFT_IN.copy()
    scaled[2] *= np.float32(0.5)
    for r in range(WORLD):
        np.testing.assert_array_equal(_bits(port[r]["drift"]),
                                      _bits(drift[r]))
        np.testing.assert_allclose(port[r]["drift"], scaled.mean(0),
                                   rtol=0, atol=1e-6)
    assert not np.allclose(drift[0], DRIFT_IN.mean(0), rtol=0, atol=1e-3)


# -- one rank -------------------------------------------------------------------

@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


def test_fallback_window_engages_and_rearms_on_jaxs_steps(group):
    K, M, steps = 3, 4, 16
    grads = make_grads(steps, seed=4)
    kw = {"fallback_after": K, "fallback_steps": M}
    ref = run_jax(_jax_chaos_grace(TOPK_EF, nan_prob=1.0, rank=0, seed=7),
                  grads, 1, steps, kw)
    port = run_port(_port_chaos_grace(TOPK_EF, group, nan_prob=1.0, rank=0,
                                      seed=7), grads, 0, steps, kw)
    flags = [p["fallback"] for p in port]
    nf = [int(p["counters"][0]) for p in port]
    assert flags == [bool(r["fallback"][0]) for r in ref]
    for s in range(steps):
        np.testing.assert_array_equal(port[s]["counters"],
                                      ref[s]["counters"][0])
    assert nf[:K] == list(range(1, K + 1))
    assert flags[:K] == [False] * (K - 1) + [True]
    assert flags[K - 1:K - 1 + M] == [True] * M
    assert flags[K - 1 + M] is False
    assert nf[2 * K + M - 1] == 2 * K


def test_chaos_is_deterministic(group):
    grads = make_grads(8, seed=5)

    def run(seed):
        outs = run_port(_port_chaos_grace(TOPK_EF, group, nan_prob=0.25,
                                          rank=0, seed=seed),
                        grads, 0, 8, {})
        return outs[-1]

    # A bad step keeps the GRACE counter, and with it the step's keys, so
    # after the first hit every step is hit again (as in JAX).
    a, b = run(18), run(18)
    assert a["counters"][0] == 6         # seed 18 misses two steps first
    np.testing.assert_array_equal(a["counters"], b["counters"])
    for n in SHAPES:
        np.testing.assert_array_equal(_bits(a["params"][n]),
                                      _bits(b["params"][n]))
    assert run(16)["counters"][0] == 7   # another seed, another pattern


def test_implant_and_bitflip_primitives():
    key = LeafKey(0, 0, 0)
    nanned = _implant(torch.zeros(13), key, float("nan"))
    assert int(torch.isnan(nanned).sum()) == 1
    t = torch.randn(64, generator=torch.Generator().manual_seed(1))
    flipped = _flip_one_bit(t, key)
    xor = (t.view(torch.int32) ^ flipped.view(torch.int32)).numpy().view(
        np.uint32)
    assert (xor != 0).sum() == 1
    assert bin(int(xor[xor != 0][0])).count("1") == 1
    for dtype in (torch.float16, torch.float64, torch.int8):
        x = torch.ones(9, dtype=dtype)
        y = _flip_one_bit(x, key.fold(3))
        assert (x != y).sum() == 1
    assert _flip_one_bit(torch.ones(3, dtype=torch.bool), key).all()


def _force_inplace(monkeypatch):
    one = chunk_topk.chunk_compress_feedback

    def call(x, residual, *args, **kwargs):
        vals, win, new = one(x, residual, *args, **kwargs)
        if residual is None:
            return vals, win, new
        residual.copy_(new.reshape(residual.shape))
        return vals, win, residual

    monkeypatch.setattr(chunk_topk, "chunk_compress_feedback", call)


@pytest.mark.parametrize("algorithm", ["exact", "chunk"])
def test_stale_residual_fault(group, monkeypatch, algorithm):
    """``stale_prob=1`` drops the residual update: the exchange is the
    clean one, and the memory keeps its old value, even where the chunk
    kernel writes the residual in place."""
    _force_inplace(monkeypatch)
    comp = TopKCompressor(compress_ratio=0.25, algorithm=algorithm)
    memory = ResidualMemory()
    g = torch.linspace(-1, 1, 64)
    clean = Allgather(group=group)
    stale = ChaosCommunicator(inner=Allgather(group=group), stale_prob=1.0,
                              seed=3)
    runs = []
    for comm in (clean, stale):
        mem = torch.full((64,), 0.5)
        out, new_mem, _ = comm.step(g, mem, None, memory, comp,
                                    LeafKey(0, 0, 0))
        runs.append((out, mem, new_mem))
    (out_c, _, mem_c), (out_s, old_s, mem_s) = runs
    assert torch.equal(out_c, out_s)
    assert not torch.equal(mem_c, torch.full((64,), 0.5))
    assert torch.equal(mem_s, torch.full((64,), 0.5))


def test_chaos_compressor_payload_bitflip(group):
    def run(comp):
        out, _, _ = Allgather(group=group).step(
            torch.linspace(-1, 1, 32), None, None, NoneMemory(), comp,
            LeafKey(5, 0, 0))
        return out

    base = run(NoneCompressor())
    assert torch.equal(base, run(ChaosCompressor(inner=NoneCompressor())))
    assert not torch.equal(base, run(ChaosCompressor(
        inner=NoneCompressor(), bitflip_prob=1.0, seed=9)))


def test_shared_scale_drift_stays_on_the_lattice(group):
    inner = HomoQSGDCompressor(quantum_num=7)
    comp = ChaosCompressor(inner=inner, drift_scale=0.5)
    x = torch.linspace(-1, 1, 64)
    shared = inner.negotiate(x, group)
    want, _, _ = inner.compress(x, None, LeafKey(1, 0, 0), shared=shared)
    got, _, _ = comp.compress(x, None, LeafKey(1, 0, 0), shared=shared)
    for w, g in zip(want, got):
        if w.is_floating_point() or w.dtype == torch.bool:
            continue
        assert torch.equal(g, torch.round(w.float() * 0.5).to(w.dtype))


def test_chaos_compressor_delegates_the_contract_but_no_kernel_hooks():
    inner = TopKCompressor(compress_ratio=0.01, algorithm="chunk")
    comp = ChaosCompressor(inner=inner)
    for attr in ("average", "tensors_size_are_same", "vote_aggregate",
                 "payload_algebra", "supports_hop_requant", "negotiates",
                 "summable_payload"):
        assert getattr(comp, attr) == getattr(inner, attr), attr
    for hook in ("fused_feedback_compress", "fused_feedback_compress_leaves",
                 "fused_aggregate_decompress",
                 "fused_aggregate_decompress_leaves",
                 "fused_roundtrip_leaves"):
        assert hasattr(inner, hook) and not hasattr(comp, hook), hook
    ring = RingAllreduce()
    chaos_ring = ChaosCommunicator(inner=ring)
    assert chaos_ring.shard_parallel and chaos_ring.group is ring.group
    assert chaos_ring.recv_link_bytes(4096, 1024, 8) == \
        ring.recv_link_bytes(4096, 1024, 8)
    with pytest.raises(TypeError, match="inner=Communicator"):
        ChaosCommunicator()


def test_chaos_pipeline_takes_the_staged_path(group, monkeypatch):
    """The chunk kernels' wrappers are called by the bare Top-K pipeline
    (exchange and telemetry round-trip) and never under ChaosCompressor."""
    calls = []
    for name in ("chunk_compress_feedback", "chunk_compress_feedback_grouped",
                 "chunk_aggregate_dense", "chunk_aggregate_dense_grouped"):
        real = getattr(chunk_topk, name)

        def counted(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(chunk_topk, name, counted)
    cfg = {**TOPK_EF, "telemetry": True}
    grads = {n: torch.from_numpy(a[0, 0].copy())
             for n, a in make_grads(1, seed=6).items()}
    for wrap in (False, True):
        grc = grace_from_params(cfg, group=group)
        if wrap:
            grc = dataclasses.replace(grc, compressor=ChaosCompressor(
                inner=grc.compressor))
        tx = grc.transform(seed=1)
        calls.clear()
        tx.update({n: g.clone() for n, g in grads.items()},
                  tx.init({n: torch.zeros_like(g)
                           for n, g in grads.items()}))
        if wrap:
            assert calls == []
        else:
            assert sorted(calls) == ["chunk_aggregate_dense_grouped",
                                     "chunk_compress_feedback_grouped",
                                     "chunk_compress_feedback_grouped"]


def test_guard_report_sees_the_chaos(group):
    grads = make_grads(3, seed=7)
    chain = guarded_chain(_port_chaos_grace(TOPK_EF, group, nan_prob=1.0,
                                            seed=2))
    ps = {n: torch.nn.Parameter(torch.from_numpy(a))
          for n, a in make_params().items()}
    opt = torch.optim.SGD(ps.values(), lr=0.25)
    st = chain.init(ps)
    for s in range(3):
        st = chain.apply(ps, {n: torch.from_numpy(a[0, s].copy())
                              for n, a in grads.items()}, st, opt)
    assert guard_report(st)["notfinite_count"] == 3
