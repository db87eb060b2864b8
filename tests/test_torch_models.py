"""The port's model zoo against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; weights are the JAX package's,
carried across with ``convert.from_jax`` (dicts by key, the transformer's
``"layers"`` list by index) and jittered with numpy so that every path
carries values of order one (LayerNorm scales and biases, BatchNorm
parameters and state, the transformer's weights at ``1/sqrt(din)``).

* Layers: LayerNorm (eps 1e-6, a low-variance input where eps 1e-5 would
  show; float32 within ``rtol=1e-5, atol=1e-6``, bfloat16 within one
  bfloat16 rounding), Embedding (bit for bit), the truncated-normal init
  (bounds ±2·std and the truncated std, from both packages' draws),
  ``Dense(use_bias=False)``, ``avg_pool`` (VALID and SAME, count excluding
  the padding) and the adaptive pool against JAX's ``_adaptive_avg_pool``
  at grids 1, 2, 5, 7, 8 and 14 (``rtol=1e-6, atol=1e-6``).
* A 12-layer ``tiny`` transformer in float32: classification logits with
  and without a mask, ``mlm_logits``, and every leaf's gradient of a loss
  over both heads, within ``rtol=1e-4`` and an ``atol`` of 1e-5 times the
  leaf's largest value. The GELU is the tanh form and LayerNorm's eps
  1e-6: the exact GELU or eps 1e-5 miss these bounds. A two-layer one in
  bfloat16 within 1.5e-2 of its largest logit (measured: 4.6e-3).
* ``resnet_cifar`` at batch 4 (32×32), train and eval mode: logits, every
  gradient and the BatchNorm state within ``rtol=1e-4, atol=1e-5``.
* VGG-11 with BatchNorm at batch 2 (32×32: the adaptive pool repeats the
  1×1 grid, so an NCHW flatten permutes fc1's rows and misses): logits and
  every gradient within ``rtol=1e-4, atol=1e-5``. Its 128.8M parameters
  are freed after the test.
* ``transform.leaf_order`` equals JAX's flatten order for BERT-base, the
  12-layer ``tiny``, ResNet-50, VGG-16 with BatchNorm and ``resnet_cifar``
  (names from ``jax.eval_shape``, so no JAX weights are built); ResNet-50's
  and LeNet's orders are the plain sort of their dotted names, as before.
* BERT-base has 150 leaves and 108,793,346 parameters (51 of them 2-D);
  VGG-16 with and without BatchNorm 45 and 32 leaves; ResNet-101 and -152
  the JAX package's leaves.
"""

import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from grace_tpu.models import layers as JL
from grace_tpu.models import lenet as jlenet
from grace_tpu.models import resnet as jresnet
from grace_tpu.models import resnet_cifar as jrc
from grace_tpu.models import transformer as jt
from grace_tpu.models import vgg as jvgg
from grace_tpu.transform import leaf_path_str

from grace_tpu_torch.convert import from_jax
from grace_tpu_torch.models import layers as L
from grace_tpu_torch.models import resnet as tresnet
from grace_tpu_torch.models import transformer as tt
from grace_tpu_torch.models import vgg as tvgg
from grace_tpu_torch.models.lenet import LeNet
from grace_tpu_torch.models.resnet_cifar import ResNetCifar
from grace_tpu_torch.transform import leaf_order

RTOL, ATOL = 1e-4, 1e-5
TINY12 = jt.tiny(num_layers=12)


def _name(path) -> str:
    return leaf_path_str(path).replace("/", ".")


def _flat(tree):
    return {_name(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_names(init):
    params, _ = jax.eval_shape(init)
    return [_name(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(params)[0]]


def _jitter(tree, seed):
    """A tree of ``jax.eval_shape`` structs (so that no JAX init runs) as
    arrays drawn with numpy at order-one scale: weights
    ``N(0, 1/din)`` (tables ``N(0, 1)``), scales ``1 + U(0, 0.1)``, biases
    and means ``0.1·N(0, 1)``, variances ``1 + U(0, 0.1)``."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name, shape = _name(path), a.shape
        f32 = np.float32
        if name.endswith(("scale", "var")):
            v = 1 + f32(0.1) * rng.random(shape, f32)
        elif name.endswith(("bias", ".b", "mean")):
            v = f32(0.1) * rng.standard_normal(shape, f32)
        elif name.endswith("table"):
            v = rng.standard_normal(shape, f32)
        else:                                 # dense (din, dout), conv HWIO
            v = rng.standard_normal(shape, f32) / f32(
                np.sqrt(np.prod(shape[:-1])))
        return jnp.asarray(v)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _load(model, params, state=None):
    sd, bufs = from_jax(jax.device_get(params),
                        jax.device_get(state or {}))
    model.load_state_dict({**sd, **bufs})     # strict: every name matches
    return model


def _close(got: dict, want: dict, rtol=RTOL, atol=ATOL):
    """Every leaf of ``got`` within ``atol + rtol·|want|`` (one pass, for
    leaves of 100M elements)."""
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        bad = np.abs(got[name] - w) > atol + rtol * np.abs(w)
        assert not bad.any(), (name, int(bad.sum()),
                               float(np.abs(got[name] - w).max()))


def _close_per_leaf(got: dict, want: dict, rtol=RTOL, scale=1e-5,
                    like=None):
    """Each leaf within ``rtol`` and ``scale`` times its largest value (or
    the largest value of ``like[name]``, a leaf of the same name)."""
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        ref = w if like is None else like[name]
        atol = scale * max(float(np.abs(ref).max()), 1e-30)
        np.testing.assert_allclose(got[name], w, rtol=rtol, atol=atol,
                                   err_msg=name)


# -- layers --------------------------------------------------------------------

@pytest.mark.parametrize("std", [1.0, 3e-3])     # 3e-3: var 9e-6, eps shows
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype, std):
    rng = np.random.default_rng(0)
    x = (std * (0.5 + rng.standard_normal((3, 5, 48)))).astype(np.float32)
    p = {"scale": jnp.asarray(1 + rng.random(48), jnp.float32),
         "bias": jnp.asarray(rng.standard_normal(48), jnp.float32)}
    xj = jnp.asarray(x).astype(dtype)
    want = JL.ln_apply(p, xj)
    ln = _load_ln(p)
    got = ln(torch.from_numpy(np.asarray(xj.astype(jnp.float32)))
             .to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
           else dict(rtol=1e-2, atol=1e-2))   # one bfloat16 rounding apart
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)
    assert L.LayerNorm.eps == 1e-6


def _load_ln(p):
    ln = L.LayerNorm(48)
    with torch.no_grad():
        ln.scale.copy_(torch.from_numpy(np.array(p["scale"])))
        ln.bias.copy_(torch.from_numpy(np.array(p["bias"])))
    return ln


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_embedding_matches_jax(dtype):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (4, 7)).astype(np.int32)
    want = JL.embedding_apply({"table": jnp.asarray(table)}, jnp.asarray(ids),
                              dtype=None if dtype is None else
                              getattr(jnp, dtype))
    emb = L.Embedding(50, 8, generator=torch.Generator())
    with torch.no_grad():
        emb.table.copy_(torch.from_numpy(table))
    got = emb(torch.from_numpy(ids).long(),
              None if dtype is None else getattr(torch, dtype))
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_trunc_normal_bounds_match_jax():
    std = 0.02
    got = L.trunc_normal((400, 500), torch.Generator().manual_seed(0), std)
    want = np.asarray(JL.trunc_normal(jax.random.key(0), (400, 500), std))
    dense = L.Dense(400, 500, init="trunc",
                    generator=torch.Generator().manual_seed(1))
    for a in (got.numpy(), want, dense.w.detach().numpy()):
        assert np.abs(a).max() <= 2 * std
        assert np.abs(a).max() > 1.99 * std       # the bound, not a clip
        # The std of a normal truncated at ±2σ: 0.8796σ.
        np.testing.assert_allclose(a.std(), 0.8796 * std, rtol=1e-2)
        np.testing.assert_allclose(a.mean(), 0.0, atol=1e-4)


def test_dense_without_bias_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    w = rng.standard_normal((16, 4)).astype(np.float32)
    jp = JL.dense_init(jax.random.key(0), 16, 4, use_bias=False)
    assert set(jp) == {"w"}
    d = L.Dense(16, 4, use_bias=False, generator=torch.Generator())
    assert [n for n, _ in d.named_parameters()] == ["w"]
    with torch.no_grad():
        d.w.copy_(torch.from_numpy(w))
    want = JL.dense_apply({"w": jnp.asarray(w)}, jnp.asarray(x))
    np.testing.assert_allclose(d(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hw,window,stride,padding", [
    (8, 2, None, "VALID"), (9, 3, 2, "VALID"), (9, 3, 2, "SAME"),
    (8, 3, 1, "SAME"), (7, 2, 2, "SAME")])
def test_avg_pool_matches_jax(hw, window, stride, padding):
    x = np.random.default_rng(3).standard_normal((2, hw, hw, 3)).astype(
        np.float32)
    want = JL.avg_pool(jnp.asarray(x), window, stride, padding)
    got = L.avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), window, stride,
                     padding).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("grid", [1, 2, 5, 7, 8, 14])
def test_adaptive_avg_pool_matches_jax(grid):
    x = np.random.default_rng(grid).standard_normal(
        (2, grid, grid, 4)).astype(np.float32)
    want = jvgg._adaptive_avg_pool(jnp.asarray(x), 7)
    got = L.adaptive_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), 7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


# -- the transformer -------------------------------------------------------------

@functools.cache
def _tiny12_params():
    params, _ = jax.eval_shape(lambda: jt.init(jax.random.key(0), TINY12))
    return _jitter(params, 7)


def _tokens(n=3, t=16, seed=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY12.vocab_size, (n, t)).astype(np.int32)
    mask = rng.random((n, t)) < 0.8
    mask[:, 0] = True
    return ids, mask


def _tiny12_port():
    return _load(tt.Transformer(TINY12, device="cpu"), _tiny12_params())


@functools.cache
def _tiny12_jax():
    """JAX's logits (without and with the mask), MLM logits and every
    leaf's gradient of ``ce(logits) + mean(mlm · r)`` (masked), computed
    once, eagerly (here quicker than compiling the 12 unrolled layers)."""
    p = _tiny12_params()
    ids, mask = _tokens()
    rng = np.random.default_rng(5)
    y = rng.integers(0, 2, (3,)).astype(np.int32)
    r = rng.standard_normal((3, 16, TINY12.vocab_size)).astype(np.float32)

    def outputs(params):
        out = {}
        for masked in (False, True):
            m = jnp.asarray(mask) if masked else None
            out[f"logits{masked}"], _ = jt.apply(
                params, {}, jnp.asarray(ids), cfg=TINY12, mask=m)
            out[f"mlm{masked}"] = jt.mlm_logits(params, jnp.asarray(ids),
                                                TINY12, mask=m)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            out["logitsTrue"], jnp.asarray(y)).mean()
        return ce + jnp.mean(out["mlmTrue"] * jnp.asarray(r)), out

    grads, out = jax.grad(outputs, has_aux=True)(p)
    return ({k: np.asarray(v) for k, v in out.items()}, _flat(grads),
            (ids, mask, y, r))


@pytest.mark.parametrize("masked", [False, True])
def test_tiny12_forward_matches_jax(masked):
    want, _, (ids, mask, _, _) = _tiny12_jax()
    model = _tiny12_port()
    tm = torch.from_numpy(mask) if masked else None
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), tm)
        got_mlm = model.mlm_logits(torch.from_numpy(ids).long(), tm)
    assert got.dtype == got_mlm.dtype == torch.float32
    for g, w in ((got, want[f"logits{masked}"]),
                 (got_mlm, want[f"mlm{masked}"])):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=1e-5 * np.abs(w).max())


def test_tiny12_gradients_match_jax():
    _, want, (ids, mask, y, r) = _tiny12_jax()
    model = _tiny12_port()
    tid, tmask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    loss = (F.cross_entropy(model(tid, tmask), torch.from_numpy(y).long())
            + (model.mlm_logits(tid, tmask) * torch.from_numpy(r)).mean())
    loss.backward()
    got = {n: q.grad.numpy() for n, q in model.named_parameters()}
    assert len(got) == 150
    _close_per_leaf(got, want)


def test_tiny_bf16_forward_matches_jax():
    """The bfloat16 path (the card's compute dtype): tables and weights
    cast per call, the softmax in float32, masked with -1e9 in bfloat16,
    the logits float32; within 1.5e-2 of the largest logit (a few bfloat16
    roundings through two layers)."""
    cfg = jt.tiny(d_model=48, num_heads=4)       # dh = 12: sqrt(12) rounds
    params = _jitter(jax.eval_shape(
        lambda: jt.init(jax.random.key(0), cfg))[0], 14)
    ids, mask = _tokens()
    want, _ = jt.apply(params, {}, jnp.asarray(ids), cfg=cfg,
                       mask=jnp.asarray(mask), dtype=jnp.bfloat16)
    model = _load(tt.Transformer(cfg, device="cpu"), params)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                    dtype=torch.bfloat16)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1.5e-2 * np.abs(want).max())


def test_encode_past_max_len_raises_as_jax():
    ids = np.zeros((1, TINY12.max_len + 1), np.int32)
    with pytest.raises(ValueError) as want:
        jt.encode(_tiny12_params(), jnp.asarray(ids), TINY12)
    with pytest.raises(ValueError) as got:
        tt.Transformer(TINY12, device="cpu").encode(
            torch.from_numpy(ids).long())
    assert str(got.value) == str(want.value)


def test_bf16_encode_keeps_float32_parameters():
    model = tt.Transformer(tt.tiny(), device="cpu")
    ids = torch.zeros((2, 8), dtype=torch.long)
    x = model.encode(ids, dtype=torch.bfloat16)
    assert x.dtype == torch.bfloat16
    assert model(ids, dtype=torch.bfloat16).dtype == torch.float32
    assert all(q.dtype == torch.float32 for q in model.parameters())


# -- resnet_cifar and VGG ---------------------------------------------------------

def _images(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, (n,)).astype(np.int32))


def _jax_step(apply, params, state, x, y, train):
    def loss(p):
        logits, new = apply(p, state, jnp.asarray(x), train=train)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
        return ce, (logits, new)
    (_, (logits, new)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    return np.asarray(logits), _flat(new), _flat(grads)


def _port_step(model, x, y, train):
    model.train(train)
    logits = model(torch.from_numpy(x))
    F.cross_entropy(logits, torch.from_numpy(y).long()).backward()
    return (logits.detach().numpy(),
            {n: b.numpy() for n, b in model.named_buffers()},
            {n: q.grad.numpy() for n, q in model.named_parameters()})


@pytest.mark.parametrize("train", [True, False])
def test_resnet_cifar_matches_jax(train):
    params, state = jax.eval_shape(lambda: jrc.init(jax.random.key(1)))
    params, state = _jitter(params, 8), _jitter(state, 9)
    x, y = _images(4, 10)
    want = _jax_step(jrc.apply, params, state, x, y, train)
    model = _load(ResNetCifar(device="cpu"), params, state)
    assert len(list(model.parameters())) == 25
    assert len(list(model.buffers())) == 16
    got = _port_step(model, x, y, train)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    _close(got[1], want[1])
    _close(got[2], want[2])


def test_vgg11_bn_matches_jax():
    params, state = jax.eval_shape(lambda: jvgg.init(jax.random.key(2), 11,
                                                     10, True))
    params, state = _jitter(params, 11), _jitter(state, 12)
    x, y = _images(2, 13)
    want = _jax_step(jvgg.apply, params, state, x, y, True)
    model = _load(tvgg.VGG(11, 10, True, device="cpu"), params, state)
    del params
    assert sum(q.numel() for q in model.parameters()) == 128_810_058
    got = _port_step(model, x, y, True)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    _close(got[1], want[1])
    _close(got[2], want[2])
    del model, got, want
    gc.collect()


# -- leaf order and counts ------------------------------------------------------------

BERT_BASE = tt.base(num_classes=2, max_len=384)
ORDER_CASES = {
    "bert_base": (lambda: jt.init(jax.random.key(0), jt.base(
        num_classes=2, max_len=384)),
        lambda: tt.Transformer(BERT_BASE, device="cpu")),
    "tiny12": (lambda: jt.init(jax.random.key(0), TINY12),
               lambda: tt.Transformer(TINY12, device="cpu")),
    "resnet50": (lambda: jresnet.init(jax.random.key(0), 50),
                 lambda: tresnet.resnet50(device="cpu")),
    "vgg16_bn": (lambda: jvgg.init(jax.random.key(0), 16, 1000, True),
                 lambda: tvgg.vgg("vgg16_bn", device="cpu")),
    "resnet_cifar": (lambda: jrc.init(jax.random.key(0)),
                     lambda: ResNetCifar(device="cpu")),
}
LEAVES = {"bert_base": (150, 108_793_346), "tiny12": (150, None),
          "resnet50": (161, 25_557_032), "vgg16_bn": (45, 138_361_768),
          "resnet_cifar": (25, 6_573_120)}


def _shapes(model) -> dict:
    return {n: tuple(q.shape) for n, q in model.named_parameters()}


@pytest.fixture
def no_init(monkeypatch):
    """Layers allocate their parameters without drawing them: the names
    and shapes are all these tests read."""
    for init in ("he_normal", "glorot_uniform", "trunc_normal"):
        monkeypatch.setattr(L, init, lambda shape, *a, **k: torch.empty(shape))


@pytest.mark.parametrize("name", sorted(ORDER_CASES))
def test_leaf_order_is_jax_flatten_order(name, no_init):
    jinit, build = ORDER_CASES[name]
    shapes = _shapes(build())
    gc.collect()
    order = leaf_order(shapes)
    assert order == _jax_names(jinit)
    n_leaves, n_params = LEAVES[name]
    assert len(order) == n_leaves
    if n_params is not None:
        assert sum(int(np.prod(s)) for s in shapes.values()) == n_params
    if name == "bert_base":
        # PowerSGD factors the 2-D leaves and sends the 1-D ones dense.
        assert sum(len(s) == 2 for s in shapes.values()) == 51
        # A plain sort of the dotted names puts layers.10 before layers.2.
        plain = sorted(shapes, key=lambda n: tuple(n.split(".")))
        assert plain != order and plain.index("layers.10.ff1.b") == 26
        assert order[26] == "layers.2.ff1.b"


@pytest.mark.parametrize("build", [
    lambda: tresnet.resnet50(device="cpu"), lambda: LeNet(device="cpu")],
    ids=["resnet50", "lenet"])
def test_leaf_order_unchanged_without_list_indices(build):
    names = list(_shapes(build()))
    assert leaf_order(names) == sorted(names,
                                       key=lambda n: tuple(n.split(".")))


def test_leaf_order_sorts_list_indices_as_integers():
    names = ["layers.10.w", "layers.2.w", "conv10.w", "conv2.w", "a.0.b",
             "a.1.b", "a.11.b"]
    assert leaf_order(names) == ["a.0.b", "a.1.b", "a.11.b", "conv10.w",
                                 "conv2.w", "layers.2.w", "layers.10.w"]


def test_lenet_names_are_jax_order():
    names = list(_shapes(LeNet(device="cpu")))
    assert leaf_order(names) == _jax_names(
        lambda: jlenet.init(jax.random.key(0)))


@pytest.mark.parametrize("depth", [101, 152])
def test_deep_resnets_match_jax_leaves(depth, no_init):
    model = getattr(tresnet, f"resnet{depth}")(device="cpu")
    shapes = _shapes(model)
    names = _jax_names(lambda: jresnet.init(jax.random.key(0), depth))
    assert leaf_order(shapes) == names
    jshapes = jax.eval_shape(lambda: jresnet.init(jax.random.key(0),
                                                  depth))[0]
    assert {n: tuple(s.shape) for n, s in _flat_shapes(jshapes)} == shapes


def _flat_shapes(tree):
    return [(_name(p), s) for p, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("batch_norm,leaves,params", [
    (True, 45, 138_361_768), (False, 32, 138_357_544)])
def test_vgg16_counts_and_shapes(batch_norm, leaves, params, no_init):
    jshapes = dict(_flat_shapes(jax.eval_shape(
        lambda: jvgg.init(jax.random.key(0), 16, 1000, batch_norm))[0]))
    shapes = _shapes(tvgg.vgg("vgg16_bn" if batch_norm else "vgg16",
                              device="cpu"))
    gc.collect()
    assert {n: tuple(s.shape) for n, s in jshapes.items()} == shapes
    assert len(shapes) == leaves
    assert sum(int(np.prod(s)) for s in shapes.values()) == params


def test_from_jax_flattens_lists_by_index():
    tree = {"layers": [{"w": np.ones(2)}, {"w": np.zeros(3)}],
            "cls": {"b": np.arange(2.0)}}
    sd, _ = from_jax(tree, {})
    assert sorted(sd) == ["cls.b", "layers.0.w", "layers.1.w"]
    assert sd["layers.1.w"].shape == (3,)
