"""The port's codecs, memory and ``Communicator.step`` against the JAX
package's staged path, bit for bit; and the port's builders and gates.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs its staged path (``use_pallas=False``) with the ``Identity``
communicator; the port runs both its fused path (the chunk kernels' plain
versions on the CPU) and its staged path.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grace_tpu import comm as jcomm
from grace_tpu import compressors as jC
from grace_tpu import memories as jM

from grace_tpu_torch import comm, grace_from_params, grace_transform
from grace_tpu_torch.compressors import NoneCompressor, TopKCompressor
from grace_tpu_torch.core import LeafKey
from grace_tpu_torch.memories import NoneMemory, ResidualMemory

TOPK1 = {"compressor": "topk", "compress_ratio": 0.01,
         "topk_algorithm": "chunk", "memory": "residual",
         "communicator": "allgather", "fusion": "none"}
DENSE = {"compressor": "none", "memory": "none", "communicator": "allreduce",
         "fusion": "none"}


def _bits(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def _t2n(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return _bits(t.numpy())


def assert_same_bits(port, ref):
    np.testing.assert_array_equal(_t2n(port), _bits(ref))


def _jax_step(compressor, memory, x, resid):
    """JAX ``Identity.step``, run eagerly: with the staged codec it touches
    no mesh axis."""
    return jcomm.Identity(axis_name="data").step(
        x, resid, None, memory, compressor, jax.random.key(0))[:2]


CODEC_CASES = [
    # (algorithm, shape, ratio, wire_dtype)
    ("chunk", (1000,), 0.01, "float32"),
    ("chunk", (3, 3, 8, 16), 0.01, "float32"),     # tail row
    ("chunk", (1003,), 0.013, "bfloat16"),
    ("chunk", (64,), 0.01, "float32"),             # k=1
    ("chunk", (10,), 0.3, "float32"),              # n < 2k: exact path
    ("exact", (40, 25), 0.05, "float32"),
    ("exact", (257,), 0.04, "bfloat16"),
]


@pytest.mark.parametrize("algorithm,shape,ratio,wire", CODEC_CASES)
def test_topk_codec_matches_jax(algorithm, shape, ratio, wire):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jc = jC.TopKCompressor(compress_ratio=ratio, algorithm=algorithm,
                           wire_dtype=wire, use_pallas=False)
    tc = TopKCompressor(compress_ratio=ratio, algorithm=algorithm,
                        wire_dtype=wire, use_pallas=False)
    (jv, ji), jctx, _ = jc.compress(jnp.asarray(x), None, jax.random.key(0))
    (tv, ti), tctx, _ = tc.compress(torch.from_numpy(x), None,
                                    LeafKey(0, 0, 0))
    assert_same_bits(tv, jv)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32
    assert_same_bits(tc.decompress((tv, ti), tctx),
                     jc.decompress((jv, ji), jctx))


STEP_CASES = [
    # (shape, ratio, wire, beta, gamma, state_dtype)
    ((1000,), 0.01, "float32", 1.0, 1.0, None),
    ((3, 3, 8, 16), 0.01, "float32", 1.0, 1.0, None),
    ((1003,), 0.013, "bfloat16", 1.0, 1.0, None),
    ((64,), 0.01, "float32", 1.0, 1.0, None),
    ((2048,), 0.05, "float32", 0.9, 0.5, None),
    ((1003,), 0.013, "float32", 1.0, 1.0, "bfloat16"),   # staged in both
]


def _step_inputs(case):
    shape, ratio, wire, beta, gamma, state_dtype = STEP_CASES[case]
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    resid = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    if state_dtype:
        resid = np.asarray(jnp.asarray(resid).astype(state_dtype)
                           .astype(jnp.float32))
    return x, resid


@functools.cache
def _jax_reference(case):
    shape, ratio, wire, beta, gamma, state_dtype = STEP_CASES[case]
    x, resid = _step_inputs(case)
    jc = jC.TopKCompressor(compress_ratio=ratio, algorithm="chunk",
                           wire_dtype=wire, use_pallas=False)
    jmem = jM.ResidualMemory(beta=beta, gamma=gamma, state_dtype=state_dtype)
    out, mem = _jax_step(jc, jmem, jnp.asarray(x),
                         jnp.asarray(resid).astype(state_dtype or "float32"))
    return np.asarray(out), np.asarray(mem)


@pytest.mark.parametrize("use_pallas", [True, "auto", False])
@pytest.mark.parametrize("case", range(len(STEP_CASES)))
def test_step_matches_jax_staged(case, use_pallas):
    shape, ratio, wire, beta, gamma, state_dtype = STEP_CASES[case]
    x, resid = _step_inputs(case)
    tmem = ResidualMemory(beta=beta, gamma=gamma, state_dtype=state_dtype)
    tr = torch.from_numpy(resid).to(
        getattr(torch, state_dtype) if state_dtype else torch.float32)
    tc = TopKCompressor(compress_ratio=ratio, algorithm="chunk",
                        wire_dtype=wire, use_pallas=use_pallas)
    out_t, mem_t, _ = comm.Identity().step(torch.from_numpy(x), tr, None,
                                           tmem, tc, LeafKey(0, 0, 0))
    out_j, mem_j = _jax_reference(case)
    assert_same_bits(out_t, out_j)
    assert_same_bits(mem_t, mem_j)


def test_fused_path_taken_and_gated():
    tc = TopKCompressor(compress_ratio=0.01, algorithm="chunk")
    x, st = torch.ones(1000), torch.zeros(1000)
    assert tc.fused_feedback_compress(x, st, (1.0, 1.0),
                                      LeafKey(0, 0, 0)) is not None
    # The semantic gates send these down the staged path.
    for c, xx, ss in (
            (TopKCompressor(compress_ratio=0.01, algorithm="exact"), x, st),
            (TopKCompressor(compress_ratio=0.6, algorithm="chunk"), x, st),
            (TopKCompressor(compress_ratio=0.01, algorithm="chunk",
                            use_pallas=False), x, st),
            (tc, x.bfloat16(), st.bfloat16()),
            (tc, x, st.bfloat16())):
        assert c.fused_feedback_compress(xx, ss, (1.0, 1.0),
                                         LeafKey(0, 0, 0)) is None


@pytest.mark.parametrize("name,dtype", [("fp16", "float16"),
                                        ("bf16", "bfloat16"),
                                        ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("memory", ["none", "residual"])
def test_fp16_codec_matches_jax(name, dtype, memory):
    """The half-precision downcast through ``Communicator.step``: payload,
    decoded tensor and residual bit for bit against the JAX package, with
    values past float16's range, below its normal range and a signed
    zero."""
    from grace_tpu_torch.compressors import FP16Compressor
    x = np.random.default_rng(11).standard_normal((7, 13)).astype(np.float32)
    x[0, :4] = [7e4, -7e4, 3e-6, -0.0]
    resid = np.random.default_rng(12).standard_normal(x.shape).astype(
        np.float32) * 0.1
    g = grace_from_params({"compressor": name, "memory": memory,
                           "communicator": "identity"})
    assert g.compressor == FP16Compressor(dtype=dtype)
    assert g.compressor.payload_algebra == "exact"
    assert not g.compressor.supports_hop_requant
    jc = jC.FP16Compressor(dtype=dtype)
    jm = jM.ResidualMemory() if memory == "residual" else jM.NoneMemory()
    st = torch.from_numpy(resid) if memory == "residual" else None
    out, ms, _ = g.communicator.step(torch.from_numpy(x), st, None, g.memory,
                                     g.compressor, LeafKey(0, 0, 0))
    want, want_ms = _jax_step(jc, jm, jnp.asarray(x),
                              jnp.asarray(resid) if st is not None else None)
    assert_same_bits(out, want)
    if memory == "residual":
        assert_same_bits(ms, want_ms)
    payload, ctx, _ = g.compressor.compress(torch.from_numpy(x), None,
                                            LeafKey(0, 0, 0))
    (jpayload,), jctx, _ = jc.compress(jnp.asarray(x), None,
                                       jax.random.key(0))
    np.testing.assert_array_equal(payload[0].view(torch.int16).numpy(),
                                  np.asarray(jpayload).view(np.int16))
    assert ctx == torch.float32 and jctx == jnp.float32
    with pytest.raises(ValueError, match="half dtype"):
        FP16Compressor(dtype="float8")


def test_none_codec_and_memory():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 5)).astype(np.float32))
    out, ms, cs = comm.Identity().step(x.clone(), None, None, NoneMemory(),
                                       NoneCompressor(), LeafKey(0, 0, 0))
    assert ms is None and cs is None
    assert torch.equal(out, x)
    assert NoneCompressor().summable_payload
    assert not TopKCompressor().summable_payload
    with pytest.raises(TypeError):
        NoneCompressor(0.005)                  # average is keyword-only


def test_residual_memory_state_dtype():
    mem = ResidualMemory(state_dtype="bfloat16")
    assert mem.init_state(torch.ones(3)).dtype == torch.bfloat16
    assert ResidualMemory().init_state(torch.ones(3)).dtype == torch.float32
    assert mem.linear_feedback_coeffs == (1.0, 1.0)
    with pytest.raises(ValueError):
        ResidualMemory(state_dtype="float8")


def test_grace_from_params_builds_the_benchmark_pair():
    g = grace_from_params(TOPK1)
    assert isinstance(g.compressor, TopKCompressor)
    assert g.compressor.algorithm == "chunk"
    assert g.compressor.compress_ratio == 0.01
    assert g.compressor.use_pallas == "auto"
    assert isinstance(g.memory, ResidualMemory)
    assert isinstance(g.communicator, comm.Allgather)
    d = grace_from_params(DENSE)
    assert isinstance(d.compressor, NoneCompressor)
    assert isinstance(d.memory, NoneMemory)
    assert isinstance(d.communicator, comm.Allreduce)
    assert g.transform(seed=3).seed == 3
    b = grace_from_params({"compressor": "topk", "memory": "residual",
                           "beta": 0.9, "gamma": 0.5,
                           "memory_dtype": "bfloat16",
                           "communicator": "broadcast", "world_size": 8})
    assert b.memory == ResidualMemory(0.9, 0.5, "bfloat16")
    assert isinstance(b.communicator, comm.Broadcast)


def test_topk_over_allreduce_raises_type_error():
    g = grace_from_params(dict(TOPK1, communicator="allreduce"))
    x = torch.randn(1000)
    with pytest.raises(TypeError, match="summable_payload"):
        g.communicator.step(x, torch.zeros(1000), None, g.memory,
                            g.compressor, LeafKey(0, 0, 0))


@pytest.mark.parametrize("params,match", [
    ({"telemetry": {"capacity": 0}}, "telemetry"),
    ({"compressor": "nonsense"}, "nonsense"),
    ({"route": [("b*", {"compressor": "fp16"})], "fusion": "flat"},
     "route"),
    ({"communicator": "ring", "pipeline": 0}, "ring"),
    ({"compressor": "qsgd", "quantum_num": 40000}, "quantum_num"),
    ({"escape": "fp8"}, "escape"),
    ({"fusion": "flatten"}, "flat"),
    ({"fusion": "1048576"}, "1048576"),
])
def test_unported_names_raise_value_error(params, match):
    with pytest.raises(ValueError, match=match):
        grace_from_params(params)


def test_unported_options_raise():
    with pytest.raises(ValueError, match="fusion"):
        grace_transform(NoneCompressor(), NoneMemory(), comm.Identity(),
                        fusion="bucketed")
    # fsdp_axis is ported: a 2-D Grace builds (the axes alone, no mesh
    # groups); a misspelt key raises, naming it
    assert grace_from_params({"fsdp_axis": "fsdp"}).mesh.axes == \
        ("data", "fsdp")
    with pytest.raises(ValueError, match="fsdp_axes"):
        grace_from_params({"fsdp_axes": "fsdp"})
    with pytest.raises(ValueError):
        TopKCompressor(use_pallas=1)
    with pytest.raises(ValueError):
        TopKCompressor(algorithm="sorted")


def test_approx_topk_equals_jax_approx():
    """``topk_algorithm='approx'`` builds, and equals the JAX package's
    ``approx`` on the CPU bit for bit (XLA lowers ``approx_max_k`` to an
    exact selection off the TPU): payload and decompressed tensor."""
    x = np.random.default_rng(2).standard_normal(5000).astype(np.float32)
    for ratio in (0.01, 0.3):            # n > 4k, and the exact branch
        tc = grace_from_params({"compressor": "topk",
                                "compress_ratio": ratio,
                                "topk_algorithm": "approx"}).compressor
        jc = jC.TopKCompressor(compress_ratio=ratio, algorithm="approx")
        (tv, ti), tctx, _ = tc.compress(torch.from_numpy(x), None,
                                        LeafKey(0, 0, 0))
        jv, ji = jax.jit(
            lambda a: jc.compress(a, None, jax.random.key(0))[0])(
                jnp.asarray(x))
        jctx = jc.compress(jnp.asarray(x), None, jax.random.key(0))[1]
        assert_same_bits(tv, jv)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert_same_bits(tc.decompress((tv, ti), tctx),
                         jc.decompress((jv, ji), jctx))


def test_leaf_key_contract():
    a = LeafKey(0, 5, 3)
    assert a.derived_seed() == LeafKey(0, 5, 3).derived_seed()
    seeds = {LeafKey(s, c, i).derived_seed()
             for s in range(2) for c in range(4) for i in range(8)}
    assert len(seeds) == 64
    x = torch.rand(4, generator=a.generator("cpu"))
    assert torch.equal(x, torch.rand(4, generator=a.generator("cpu")))


def test_entry_points_default_to_cuda():
    from grace_tpu_torch.models.resnet import resnet50
    from grace_tpu_torch.parallel import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resnet50()
    assert resolve_device("cpu") == torch.device("cpu")


# -- randomk -------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _JaxPermKey(LeafKey):
    """A key whose permutation is ``jax.random.permutation`` under the
    counterpart key ``fold_in(key(seed), *folds)``."""

    def permutation(self, n, device):
        k = jax.random.key(self.seed)
        for f in self.folds:
            k = jax.random.fold_in(k, f)
        return torch.from_numpy(np.array(
            jax.random.permutation(k, n))).long().to(device)


@pytest.mark.parametrize("shape", [(1000,), (37, 5)])
@pytest.mark.parametrize("ratio", [0.01, 0.3, 0.5])
def test_randomk_matches_jax_under_the_same_indices(ratio, shape):
    from grace_tpu_torch.compressors import RandomKCompressor
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape).astype(np.float32)
    key = _JaxPermKey(4, 0, 0).fold(2)
    port = RandomKCompressor(compress_ratio=ratio)
    (values,), ctx, _ = port.compress(torch.from_numpy(x), None, key)
    jax_codec = jC.RandomKCompressor(compress_ratio=ratio)
    (want,), jctx, _ = jax_codec.compress(
        jnp.asarray(x), None, jax.random.fold_in(jax.random.key(4), 2))
    assert values.numel() == max(1, int(x.size * ratio))
    assert_same_bits(values, want)
    out = port.decompress((values,), ctx)
    assert out.shape == shape
    assert_same_bits(out, jax_codec.decompress((want,), jctx))


def test_randomk_indices_are_shared_by_equal_keys():
    """Two ranks hold equal keys for the same (step, leaf, fold): they keep
    the same lanes, so their payloads sum exactly; another key, or another
    fold, keeps other lanes."""
    from grace_tpu_torch.compressors import RandomKCompressor
    codec = RandomKCompressor(compress_ratio=0.25)
    a, b = torch.randn(400), torch.randn(400)
    key = LeafKey(0, 3, 7).fold(1)
    (va,), ctx_a, _ = codec.compress(a, None, key)
    (vb,), ctx_b, _ = codec.compress(b, None, LeafKey(0, 3, 7).fold(1))
    assert ctx_a == ctx_b
    kept = codec.decompress((torch.ones(100),), ctx_a) != 0
    assert int(kept.sum()) == 100
    np.testing.assert_array_equal(
        codec.decompress((va + vb,), ctx_a).numpy(),
        torch.where(kept, a + b, torch.zeros(())).numpy())
    for other in (LeafKey(0, 4, 7).fold(1), LeafKey(0, 3, 7).fold(2)):
        moved = codec.decompress((torch.ones(100),),
                                 codec.compress(a, None, other)[1]) != 0
        assert not torch.equal(moved, kept)
    assert torch.equal(key.permutation(400, "cpu"),
                       LeafKey(0, 3, 7).fold(1).permutation(400, "cpu"))


def test_grace_from_params_builds_randomk():
    from grace_tpu_torch.compressors import RandomKCompressor
    g = grace_from_params({"compressor": "randomk", "compress_ratio": 0.1,
                           "communicator": "ring"})
    assert g.compressor == RandomKCompressor(compress_ratio=0.1)
    assert grace_from_params({"compressor": "randomk"}).compressor == \
        RandomKCompressor(compress_ratio=0.3)
