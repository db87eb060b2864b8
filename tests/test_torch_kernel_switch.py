"""The port's kernel switch (``grace_tpu_torch.ops.pallas_disabled`` and
``pallas_mode``) against the JAX package's, and the codec paths it
selects.

``GRACE_DISABLE_PALLAS`` turns every kernel family off and
``GRACE_DISABLE_PALLAS_<FAMILY>`` one family (quant, wire, topk), with the
same false spellings and the same warning on an explicit
``use_pallas=True`` in both packages. Under a disabled family the port's
codecs take the staged path that the JAX package takes: QSGD's compress
draws ``torch.rand`` (quant), the decodes and the packed accumulate run
staged (wire), and the grouped Top-K step leaves Top-K to ``step`` (topk).
The staged and kernel paths agree bit for bit wherever the reference
promises it (everything but QSGD's random draws).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from grace_tpu import ops as jops
from grace_tpu.compressors import QSGDCompressor as JQSGD
from grace_tpu_torch import comm, ops
from grace_tpu_torch.compressors import (HomoQSGDCompressor, QSGDCompressor,
                                         SignSGDCompressor, TopKCompressor)
from grace_tpu_torch.core import LeafKey
from grace_tpu_torch.memories import ResidualMemory
from grace_tpu_torch.ops import chunk_topk, quant, wire
from grace_tpu_torch.ops.packing import pack_bits

VARS = ["GRACE_DISABLE_PALLAS"] + [f"GRACE_DISABLE_PALLAS_{f.upper()}"
                                   for f in ops.FAMILIES]
SPELLINGS = ["", "0", "false", "No", " OFF ", "1", "true", "yes", "anything"]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in VARS:
        monkeypatch.delenv(var, raising=False)


def _x(n, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(n).astype(np.float32))


def _call(fn, *args):
    """``fn(*args)`` and the RuntimeWarnings it raised."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = fn(*args)
    return out, [w for w in seen if issubclass(w.category, RuntimeWarning)]


@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("family", ops.FAMILIES)
@pytest.mark.parametrize("value", SPELLINGS)
@pytest.mark.parametrize("var", VARS)
def test_pallas_disabled_matches_jax(monkeypatch, var, value, family,
                                     explicit):
    monkeypatch.setenv(var, value)
    got, got_warn = _call(ops.pallas_disabled, explicit, family)
    want, want_warn = _call(jops.pallas_disabled, explicit, family)
    assert got is want
    assert len(got_warn) == len(want_warn) == int(got and explicit)
    if got_warn:
        assert var.strip() in str(got_warn[0].message)
        assert "use_pallas=True" in str(got_warn[0].message)


@pytest.mark.parametrize("use_pallas", [True, False, "auto"])
@pytest.mark.parametrize("family", ops.FAMILIES)
@pytest.mark.parametrize("var", [None] + VARS)
def test_pallas_mode_matches_jax(monkeypatch, var, family, use_pallas):
    """``pallas_mode`` is JAX's ``enabled`` for True and False; ``'auto'``
    takes the kernel path in the port (its CPU path is the kernel's plain
    version) where JAX's is staged off the TPU."""
    if var is not None:
        monkeypatch.setenv(var, "1")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = ops.pallas_mode(use_pallas, family)
        enabled, _ = jops.pallas_mode(use_pallas, family)
    disabled = var in ("GRACE_DISABLE_PALLAS",
                       f"GRACE_DISABLE_PALLAS_{family.upper()}")
    if use_pallas == "auto":
        assert got is not disabled
        assert enabled is False                      # JAX off the TPU
    else:
        assert got is enabled is (use_pallas is True and not disabled)


def test_pallas_mode_refuses_an_unknown_family():
    with pytest.raises(ValueError, match="family"):
        ops.pallas_mode(True, "quantize")


# -- quant: QSGD and signSGD encode on their staged paths ---------------------

@pytest.mark.parametrize("q", [7, 64])
def test_quant_disabled_qsgd_compress_is_the_staged_path(monkeypatch, q):
    x = _x(3000, seed=q)
    key = LeafKey(5, 2, 1)
    kernel = QSGDCompressor(quantum_num=q, use_pallas=True)
    staged = dataclasses.replace(kernel, use_pallas=False)
    want, wctx, _ = staged.compress(x, None, key)
    on, _, _ = kernel.compress(x, None, key)
    monkeypatch.setenv("GRACE_DISABLE_PALLAS_QUANT", "1")
    with pytest.warns(RuntimeWarning, match="GRACE_DISABLE_PALLAS_QUANT"):
        got, gctx, _ = kernel.compress(x, None, key)
    assert gctx == wctx
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(on[0], want[0])   # the hash draws differ
    # JAX's codec under the same variable: staged encode, wire on.
    jc = JQSGD(quantum_num=q, use_pallas=True)
    with pytest.warns(RuntimeWarning):
        assert jc._pallas_mode()[0] is False
    assert jc._wire_mode()[0] is True


def test_quant_disabled_signsgd_packs_staged(monkeypatch):
    x = _x(1001, seed=3)
    x[:3] = torch.tensor([0.0, -0.0, float("nan")])
    codec = SignSGDCompressor(use_pallas=True)
    want, _, _ = codec.compress(x, None, LeafKey(0, 0, 0))
    monkeypatch.setenv("GRACE_DISABLE_PALLAS_QUANT", "yes")

    def refuse(*args, **kwargs):
        raise AssertionError("the sign-pack kernel path ran")

    monkeypatch.setattr(quant, "sign_pack", refuse)
    monkeypatch.setattr(quant, "sign_pack_grouped", refuse)
    with pytest.warns(RuntimeWarning):
        got, _, _ = codec.compress(x, None, LeafKey(0, 0, 0))
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[0], pack_bits(x >= 0))
    with pytest.warns(RuntimeWarning):
        assert codec.fused_feedback_compress_leaves(
            [x], [None], None, [LeafKey(0, 0, 0)]) is None
    assert codec.wire_fused()                # the wire family stays on


# -- wire: the decodes and the packed accumulate on their staged paths --------

def test_wire_disabled_keeps_compress_on_the_kernel_path(monkeypatch):
    """As JAX's ``_wire_mode``: the decode family off, the encode on."""
    x = _x(5000, seed=11)
    key = LeafKey(1, 0, 0)
    codec = QSGDCompressor(quantum_num=7, use_pallas=True)
    want, _, _ = codec.compress(x, None, key)
    assert codec.wire_fused()
    monkeypatch.setenv("GRACE_DISABLE_PALLAS_WIRE", "true")
    with pytest.warns(RuntimeWarning, match="GRACE_DISABLE_PALLAS_WIRE"):
        assert not codec.wire_fused()
    got, _, _ = codec.compress(x, None, key)        # no warning: quant on
    assert torch.equal(got[0], want[0])
    jc = JQSGD(quantum_num=7, use_pallas=True)
    with pytest.warns(RuntimeWarning):
        assert jc.wire_fused() is False
    assert jc._pallas_mode()[0] is True
    for other in (SignSGDCompressor(use_pallas=True),
                  HomoQSGDCompressor(quantum_num=1, accum_bits=4,
                                     use_pallas=True)):
        with pytest.warns(RuntimeWarning):
            assert not other.wire_fused()


def _refuse_wire(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a wire kernel path ran")

    monkeypatch.setattr(wire, "decode_accumulate", refuse)
    monkeypatch.setattr(wire, "packed_int_accumulate", refuse)


def test_wire_disabled_decodes_are_staged_and_equal(monkeypatch):
    n = 4099
    qsgd = QSGDCompressor(quantum_num=3, use_pallas="auto")
    sign = SignSGDCompressor()
    homo = HomoQSGDCompressor(quantum_num=1, accum_bits=4)
    pays, ctxs = zip(*[qsgd.compress(_x(n, seed=s), None, LeafKey(s, 0, 0))
                       [:2] for s in range(3)])
    spays, sctxs = zip(*[sign.compress(_x(n, seed=s), None, LeafKey(0, 0, 0))
                         [:2] for s in range(3)])
    scale = torch.tensor(4.0)
    hpays = torch.stack([homo.compress(_x(n, seed=s).clamp(-4, 4), None,
                                       LeafKey(s, 0, 0), shared=scale)[0][0]
                         for s in range(3)])
    grouped = sign.fused_feedback_compress_leaves(
        [_x(n, seed=7), _x(300, seed=8)], [None, None], None, [None, None])
    want = (qsgd.decode_accumulate(pays, ctxs),
            sign.decode_accumulate(spays, sctxs),
            homo.payload_sum((hpays,))[0],
            sign.decompress_leaves(grouped[1], grouped[2]))
    monkeypatch.setenv("GRACE_DISABLE_PALLAS_WIRE", "1")
    _refuse_wire(monkeypatch)
    got = (qsgd.decode_accumulate(pays, ctxs),
           sign.decode_accumulate(spays, sctxs),
           homo.payload_sum((hpays,))[0],
           sign.decompress_leaves(grouped[1], grouped[2]))
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        assert torch.equal(w.view(-1).view(torch.uint8),
                           g.view(-1).view(torch.uint8))


# -- topk and the grouped paths in comm ---------------------------------------

@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


def _count(monkeypatch, module, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)
    return calls


def _leaves_step(cm, codec, shapes, steps=2):
    mem = ResidualMemory()
    xs = [_x(int(np.prod(s)), seed=i).view(s) for i, s in enumerate(shapes)]
    mems = [mem.init_state(x) for x in xs]
    comps = [None] * len(xs)
    outs = []
    for t in range(steps):
        rngs = [LeafKey(0, t, i) for i in range(len(xs))]
        out, mems, comps = cm.step_leaves([x * (t + 1) for x in xs], mems,
                                          comps, mem, codec, rngs)
        outs.append(out)
    return outs, mems


def _same(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


@pytest.mark.parametrize("var", ["GRACE_DISABLE_PALLAS_TOPK",
                                 "GRACE_DISABLE_PALLAS"])
def test_topk_disabled_grouped_allgather_runs_step(monkeypatch, group, var):
    """The grouped Top-K step under a disabled topk family takes no kernel
    path, grouped or one-leaf, and equals the kernel path bit for bit
    (the staged-equals-fused contract)."""
    shapes = [(40, 30), (999,), (7, 11, 3)]
    codec = TopKCompressor(compress_ratio=0.05, algorithm="chunk",
                           use_pallas=True)
    calls = _count(monkeypatch, chunk_topk,
                   ["chunk_compress_feedback_grouped",
                    "chunk_aggregate_dense_grouped",
                    "chunk_compress_feedback", "chunk_aggregate_dense"])
    want, want_mem = _leaves_step(comm.Allgather(), codec, shapes)
    assert calls["chunk_compress_feedback_grouped"] == 2
    assert calls["chunk_aggregate_dense_grouped"] == 2
    monkeypatch.setenv(var, "1")
    calls.update(dict.fromkeys(calls, 0))
    with pytest.warns(RuntimeWarning, match=var):
        got, got_mem = _leaves_step(comm.Allgather(), codec, shapes)
    assert set(calls.values()) == {0}
    for w, g in zip(want, got):
        assert _same(w, g)
    assert _same(want_mem, got_mem)


def test_quant_and_wire_disabled_vote_leaves_equal_kernel_path(monkeypatch,
                                                               group):
    """The signSGD vote's grouped path (``SignAllreduce.step_leaves``)
    under a disabled quant family runs ``step`` leaf by leaf, and under a
    disabled wire family decodes staged; both equal the kernel path."""
    shapes = [(33, 8), (1000,), (5,)]
    codec = SignSGDCompressor()
    calls = _count(monkeypatch, quant, ["sign_pack_grouped"])
    want, want_mem = _leaves_step(comm.SignAllreduce(), codec, shapes)
    assert calls["sign_pack_grouped"] == 2
    for var, grouped in (("GRACE_DISABLE_PALLAS_QUANT", 0),
                         ("GRACE_DISABLE_PALLAS_WIRE", 2)):
        monkeypatch.setenv(var, "1")
        calls["sign_pack_grouped"] = 0
        if var.endswith("WIRE"):
            _refuse_wire(monkeypatch)
        got, got_mem = _leaves_step(comm.SignAllreduce(), codec, shapes)
        monkeypatch.delenv(var)
        assert calls["sign_pack_grouped"] == grouped
        for w, g in zip(want, got):
            assert _same(w, g)
        assert _same(want_mem, got_mem)
