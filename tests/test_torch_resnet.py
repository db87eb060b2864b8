"""The port's layers, ResNet and training step against the JAX package.

A pruned JAX ResNet-50 (stem, ``s0b0``, ``s1b0`` and a 512→10 fc) is
carried into the port with ``convert.from_jax`` and run in float32 at
32×32 with batch 2. Logits, loss, every gradient leaf and the BatchNorm
state must match within ``rtol=1e-4, atol=1e-5`` (the two frameworks sum
convolutions in different orders); then two training steps under the
Top-K 1% chunk configuration must match the JAX package's staged path on a
one-device mesh within the same tolerance. Two steps under the wire path's
signSGD vote, QSGD 4-bit ring and homomorphic QSGD 4-bit ring
(``fusion='flat'``) follow, each within the tolerance its test states.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh

from grace_tpu import grace_from_params as jax_grace_from_params
from grace_tpu.models import layers as JL
from grace_tpu.models import resnet as jresnet
from grace_tpu.train import (init_stateful_train_state as jax_init_state,
                             make_stateful_train_step as jax_make_step)

from grace_tpu_torch import grace_from_params, transform
from grace_tpu_torch.convert import from_jax
from grace_tpu_torch.core import LeafKey
from grace_tpu_torch.models import layers as L
from grace_tpu_torch.models.resnet import ResNet
from grace_tpu_torch.parallel import init_process_group
from grace_tpu_torch.train import (init_stateful_train_state,
                                   make_stateful_train_step)
from grace_tpu_torch.transform import leaf_order

RTOL, ATOL = 1e-4, 1e-5
TOPK1 = {"compressor": "topk", "compress_ratio": 0.01,
         "topk_algorithm": "chunk", "memory": "residual",
         "communicator": "allgather", "fusion": "none"}
# The wire path's configurations (bench_all.py).
SIGNSGD_VOTE = {"compressor": "signsgd", "memory": "residual",
                "communicator": "sign_allreduce", "fusion": "none"}
QSGD4_RING = {"compressor": "qsgd", "quantum_num": 7, "use_pallas": True,
              "memory": "none", "communicator": "ring", "fusion": "flat"}
# The homomorphic path's configuration (bench_all.py homoqsgd4_ring_bs256).
HOMOQSGD4_RING = {"compressor": "homoqsgd", "quantum_num": 7,
                  "memory": "residual", "communicator": "ring",
                  "fusion": "flat"}
LR = 1e-3


def _path(path):
    return ".".join(str(k.key) for k in path)


def _flat(tree):
    return {_path(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.cache
def _pruned_jax_resnet():
    # The tree resnet.init builds, pruned to its first block of stages 0
    # and 1; resnet.apply reads the stage counts off the tree.
    keys = JL.split_keys(jax.random.key(0), 4)
    p, s = {}, {}
    p["stem"] = JL.conv_init(keys[0], 7, 7, 3, 64)
    p["stem_bn"], s["stem_bn"] = JL.bn_init(64)
    p["s0b0"], s["s0b0"] = jresnet._bottleneck_init(keys[1], 64, 64, 1)
    p["s1b0"], s["s1b0"] = jresnet._bottleneck_init(keys[2], 256, 128, 2)
    p["fc"] = JL.dense_init(keys[3], 512, 10, init="glorot")
    assert jresnet._stages_from_params(p) == (1, 1, 0, 0)
    # Non-trivial BatchNorm parameters and state, from a seed.
    rng = np.random.default_rng(5)

    def jitter(path, a):
        name = _path(path)
        if name.endswith(("scale", "var")):
            return jnp.asarray(1 + 0.1 * rng.random(a.shape), jnp.float32)
        if name.endswith(("bias", "mean")) and "fc" not in name:
            return jnp.asarray(0.1 * rng.standard_normal(a.shape), jnp.float32)
        return a

    p = jax.tree_util.tree_map_with_path(jitter, p)
    s = jax.tree_util.tree_map_with_path(jitter, s)
    return p, s


def _batch():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (2,)).astype(np.int32)
    return x, y


def _port_model(p, s):
    sd, bufs = from_jax(jax.device_get(p), jax.device_get(s))
    model = ResNet((1, 1, 0, 0), 10, device="cpu")
    model.load_state_dict({**sd, **bufs})        # strict: every name matches
    return model


def _jax_loss(params, mstate, batch):
    x, y = batch
    logits, new = jresnet.apply(params, mstate, x, train=True)
    loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
    return loss, (new, logits)


def _port_loss(model, batch):
    x, y = batch
    return F.cross_entropy(model(x), y)


@pytest.mark.parametrize("size,window,stride,want", [
    (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (56, 1, 2, (0, 0)),
    (56, 3, 1, (1, 1)), (7, 3, 1, (1, 1)), (32, 7, 2, (2, 3))])
def test_same_padding_is_xla_same(size, window, stride, want):
    assert L.same_padding(size, window, stride) == want


@pytest.mark.parametrize("k,stride,hw", [(7, 2, 16), (3, 2, 8), (3, 1, 8),
                                         (1, 2, 8)])
def test_conv_matches_jax(k, stride, hw):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.standard_normal((2, hw, hw, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4, 6)).astype(np.float32)
    want = JL.conv_apply({"w": jnp.asarray(w)}, jnp.asarray(x), stride=stride)
    conv = L.Conv(k, k, 4, 6, stride, generator=torch.Generator())
    with torch.no_grad():
        conv.w.copy_(torch.from_numpy(w))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


def test_max_pool_is_jax_pad_and_valid_pool():
    x = np.random.default_rng(0).standard_normal((2, 9, 9, 3)).astype(
        np.float32)
    padded = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)),
                     constant_values=-jnp.inf)
    want = JL.max_pool(padded, 3, 2)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    # What the port's ResNet runs, and the port's VALID pool on the padding.
    for got in (F.max_pool2d(xt, kernel_size=3, stride=2, padding=1),
                L.max_pool(F.pad(xt, (1, 1, 1, 1), value=-np.inf), 3, 2)):
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (3 + 2 * rng.standard_normal((4, 5, 5, 8))).astype(np.float32)
    p = {"scale": jnp.asarray(1 + rng.random(8), jnp.float32),
         "bias": jnp.asarray(rng.standard_normal(8), jnp.float32)}
    s = {"mean": jnp.asarray(rng.standard_normal(8), jnp.float32),
         "var": jnp.asarray(1 + rng.random(8), jnp.float32)}
    xj = jnp.asarray(x).astype(dtype)
    want, new_s = JL.bn_apply(p, s, xj, train=True)
    bn = L.BatchNorm(8)
    with torch.no_grad():
        for name, v in {**p, **s}.items():
            getattr(bn, name).copy_(torch.from_numpy(np.asarray(v)))
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = bn(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == xt.dtype                 # cast back to the input's
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)               # one bf16 rounding apart
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)
    # Running stats use the BIASED variance, as the JAX package does.
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(new_s["mean"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(new_s["var"]),
                               rtol=RTOL, atol=ATOL)


def test_reduced_resnet_forward_backward_matches_jax():
    p, s = _pruned_jax_resnet()
    x, y = _batch()
    (loss_j, (new_s, logits_j)), grads_j = jax.jit(jax.value_and_grad(
        _jax_loss, has_aux=True))(p, s, (jnp.asarray(x), jnp.asarray(y)))
    model = _port_model(p, s)
    # The GRACE leaf order is the JAX flatten order of the same tree.
    names = leaf_order(dict(model.named_parameters()))
    assert names == [_path(q) for q, _ in
                     jax.tree_util.tree_flatten_with_path(p)[0]]
    assert len(names) == 29
    logits = model(torch.from_numpy(x))
    loss = F.cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=RTOL)
    params = dict(model.named_parameters())
    for name, g in _flat(grads_j).items():
        np.testing.assert_allclose(params[name].grad.numpy(), g, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    buffers = dict(model.named_buffers())
    for name, v in _flat(new_s).items():
        np.testing.assert_allclose(buffers[name].numpy(), v, rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def _train_both(tmp_path, cfg, steps=2):
    """Two steps of the reduced ResNet under ``cfg`` in both packages, SGD
    at ``LR`` on a one-device mesh / a one-rank gloo group. Yields, after
    each step, (JAX state, JAX loss, port model, port loss, port state)."""
    p, s = _pruned_jax_resnet()
    x, y = _batch()
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jopt = optax.chain(jax_grace_from_params(cfg).transform(seed=0),
                       optax.sgd(LR))

    def jloss(params, mstate, batch):
        loss, (new, _) = _jax_loss(params, mstate, batch)
        return loss, new

    jstep = jax_make_step(jloss, jopt, mesh, donate=False)
    jstate = jax_init_state(p, s, jopt, mesh)
    model = _port_model(p, s)
    group, _ = init_process_group("cpu",
                                  init_method=f"file://{tmp_path}/store")
    try:
        tx = grace_from_params(cfg, group=group).transform(seed=0)
        opt = torch.optim.SGD(model.parameters(), lr=LR)
        state = init_stateful_train_state(model, tx, opt, group)
        step = make_stateful_train_step(_port_loss, tx, group)
        batch = (torch.from_numpy(x), torch.from_numpy(y).long())
        for _ in range(steps):
            jstate, jl = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
            state, loss = step(state, batch)
            yield jstate, float(jl), model, loss.item(), state
    finally:
        torch.distributed.destroy_process_group()


def test_reduced_resnet_train_steps_match_jax(tmp_path):
    for jstate, jl, model, loss, state in _train_both(tmp_path, TOPK1):
        np.testing.assert_allclose(loss, jl, rtol=RTOL)
        params = dict(model.named_parameters())
        for name, v in _flat(jstate.params).items():
            np.testing.assert_allclose(params[name].detach().numpy(), v,
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        buffers = dict(model.named_buffers())
        for name, v in _flat(jstate.model_state).items():
            np.testing.assert_allclose(buffers[name].numpy(), v,
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        jmem = jstate.opt_state[0].mem
        for i, m in enumerate(state.grace.mem):
            np.testing.assert_allclose(m.numpy(), np.asarray(jmem[i])[0],
                                       rtol=RTOL, atol=ATOL)
    assert state.grace.count == 2


class _MLP(torch.nn.Module):
    """Two dense layers with the JAX tree's names (fc1, fc2)."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.fc1 = L.Dense(16, 32, generator=gen)
        self.fc2 = L.Dense(32, 4, generator=gen)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def test_stateless_train_steps_match_jax(tmp_path):
    from grace_tpu.train import init_train_state, make_train_step as jmake

    from grace_tpu_torch.train import init_train_state as tinit
    from grace_tpu_torch.train import make_train_step

    cfg = dict(TOPK1, compress_ratio=0.1)
    rng = np.random.default_rng(11)
    p = {"fc1": JL.dense_init(jax.random.key(2), 16, 32, init="glorot"),
         "fc2": JL.dense_init(jax.random.key(3), 32, 4, init="glorot")}
    x = rng.standard_normal((8, 16)).astype(np.float32)
    y = rng.integers(0, 4, (8,)).astype(np.int32)

    def jloss(params, batch):
        h = jax.nn.relu(JL.dense_apply(params["fc1"], batch[0]))
        logits = JL.dense_apply(params["fc2"], h)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, batch[1]).mean()

    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jopt = optax.chain(jax_grace_from_params(cfg).transform(seed=0),
                       optax.sgd(1e-3))
    jstep = jmake(jloss, jopt, mesh, donate=False)
    jstate = init_train_state(p, jopt, mesh)

    model = _MLP()
    model.load_state_dict(from_jax(jax.device_get(p), {})[0])
    group, _ = init_process_group("cpu",
                                  init_method=f"file://{tmp_path}/store")
    try:
        tx = grace_from_params(cfg, group=group).transform(seed=0)
        state = tinit(model, tx, torch.optim.SGD(model.parameters(), lr=1e-3),
                      group)
        step = make_train_step(_port_loss, tx, group)
        batch = (torch.from_numpy(x), torch.from_numpy(y).long())
        for _ in range(3):
            jstate, jl = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
            state, loss = step(state, batch)
            np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
            params = dict(model.named_parameters())
            for name, v in _flat(jstate.params).items():
                np.testing.assert_allclose(params[name].detach().numpy(), v,
                                           rtol=RTOL, atol=ATOL, err_msg=name)
    finally:
        torch.distributed.destroy_process_group()


# -- the quantized wire path -------------------------------------------------

def test_reduced_resnet_signsgd_vote_steps_match_jax(tmp_path):
    """signSGD + residual + the all-reduce vote. Each step moves every
    parameter by ±LR; the two packages must move it the same way except
    where the vote may flip: where JAX's compensated gradient (residual
    plus gradient) is within 1e-4 of 0, closer than the two frameworks'
    gradients (rtol 1e-4 apart) can be told apart. Such flips must be rare
    (at most 1e-4 of the parameters), and an element that flipped is left
    out of the later comparisons. Elsewhere, losses, parameters and
    residuals agree within the model's tolerance."""
    p, _ = _pruned_jax_resnet()
    prev_j = _flat(p)
    prev_t = dict(prev_j)
    tainted = {n: np.zeros(v.shape, bool) for n, v in prev_j.items()}
    for jstate, jl, model, loss, state in _train_both(tmp_path, SIGNSGD_VOTE):
        np.testing.assert_allclose(loss, jl, rtol=RTOL)
        now_j = _flat(jstate.params)
        now_t = {n: t.detach().numpy().copy()
                 for n, t in model.named_parameters()}
        jmem = jstate.opt_state[0].mem
        for i, name in enumerate(leaf_order(now_t)):
            u_j = np.rint((prev_j[name] - now_j[name]) / LR)
            u_t = np.rint((prev_t[name] - now_t[name]) / LR)
            assert set(np.unique(u_t)) <= {-1.0, 1.0}
            jm = np.asarray(jmem[i])[0].reshape(u_j.shape)
            flipped = (u_j != u_t) & ~tainted[name]
            assert (np.abs(jm + u_j)[flipped] <= 1e-4).all(), name
            tainted[name] |= flipped
            keep = ~tainted[name]
            np.testing.assert_allclose(now_t[name][keep], now_j[name][keep],
                                       rtol=RTOL, atol=ATOL, err_msg=name)
            np.testing.assert_allclose(
                state.grace.mem[i].numpy()[keep], jm[keep], rtol=RTOL,
                atol=ATOL, err_msg=name)
        prev_j, prev_t = now_j, now_t
    n_tainted = sum(int(t.sum()) for t in tainted.values())
    assert n_tainted <= 1e-4 * sum(t.size for t in tainted.values())
    assert state.grace.count == 2


@dataclasses.dataclass(frozen=True)
class _JaxSeedKey(LeafKey):
    """A leaf key whose kernel seed is the one the JAX package draws under
    its counterpart key, ``fold_in(fold_in(key(seed), count), leaf)`` folded
    further by ``folds``: the two packages' QSGD kernels then hash the same
    seeds and draw the same roundings."""

    def seed_int32(self) -> int:
        k = jax.random.fold_in(jax.random.fold_in(jax.random.key(self.seed),
                                                  self.count), self.leaf)
        for i in self.folds:
            k = jax.random.fold_in(k, i)
        return int(jax.random.randint(k, (), 0, 2**31 - 1, jnp.int32))


def test_reduced_resnet_qsgd4_ring_flat_steps_match_jax(tmp_path,
                                                        monkeypatch):
    """QSGD 4-bit over the ring on the flat buffer, the port's kernels
    seeded with the JAX package's draws (``_JaxSeedKey``), so both encode
    the same roundings: losses, parameters and BatchNorm state match within
    the model's tolerance at both steps, as under Top-K. Each step moves
    the parameters by far more than that tolerance, so a port that skipped
    or flipped the update, or lost a level, would not pass."""
    monkeypatch.setattr(transform, "LeafKey", _JaxSeedKey)
    p, _ = _pruned_jax_resnet()
    prev = _flat(p)
    for jstate, jl, model, loss, state in _train_both(tmp_path, QSGD4_RING):
        np.testing.assert_allclose(loss, jl, rtol=RTOL)
        params = dict(model.named_parameters())
        now = _flat(jstate.params)
        moved = 0
        for name, v in now.items():
            got = params[name].detach().numpy()
            np.testing.assert_allclose(got, v, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
            # The elements this step moved, each by at least 10x ATOL.
            step = np.abs(v - prev[name])
            moved += int((step > 10 * ATOL).sum())
        assert moved > 100
        buffers = dict(model.named_buffers())
        for name, v in _flat(jstate.model_state).items():
            np.testing.assert_allclose(buffers[name].numpy(), v,
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        prev = now
    assert len(state.grace.mem) == 1 and state.grace.mem[0] is None
    assert state.grace.count == 2


@dataclasses.dataclass(frozen=True)
class _JaxUniformKey(LeafKey):
    """A leaf key whose uniforms are the JAX package's
    ``jax.random.uniform`` under its counterpart key, ``fold_in(fold_in(
    key(seed), count), leaf)`` folded further by ``folds``: the two
    packages' staged homoqsgd encodes then draw the same noise."""

    def uniform(self, shape, device):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.key(self.seed),
                                                  self.count), self.leaf)
        for i in self.folds:
            k = jax.random.fold_in(k, i)
        return torch.from_numpy(np.array(
            jax.random.uniform(k, tuple(shape)))).to(device)


def _grad_gap(params, mstate):
    """|port gradient − JAX gradient| of the reduced ResNet at the same
    parameters and batch, flat in leaf order."""
    x, y = _batch()
    (_, _), grads = jax.jit(jax.value_and_grad(_jax_loss, has_aux=True))(
        params, mstate, (jnp.asarray(x), jnp.asarray(y)))
    model = _port_model(params, mstate)
    F.cross_entropy(model(torch.from_numpy(x)),
                    torch.from_numpy(y).long()).backward()
    got = dict(model.named_parameters())
    want = _flat(grads)
    return np.concatenate([np.abs(got[n].grad.numpy() - want[n]).ravel()
                           for n in leaf_order(want)])


def test_reduced_resnet_homoqsgd4_ring_flat_steps_match_jax(tmp_path,
                                                            monkeypatch):
    """Shared-scale QSGD 4-bit over the ring on the flat buffer, with
    residual memory: the scale is negotiated on the compensated buffer, the
    stage-1 encode draws JAX's uniforms (``_JaxUniformKey``), and one
    decode scales the levels. Losses, parameters and BatchNorm state match
    the JAX package within the model's tolerance at both steps. The
    residual carries the compensated gradient itself, and at the second
    step's parameters the two frameworks' own gradients part by up to
    ~2e-3 in the early layers (a pre-activation near a ReLU's kink goes the
    other way; ``_grad_gap`` measures it at the same parameters): so the
    residual is held within the model's tolerance plus that measured gap.
    With the same noise, a level rounds the other way only where the
    compensated gradients fall on two sides of a rounding boundary. Such a
    flip must move the parameter by one decode step (LR·scale/7) and the
    residual by one level the same way (within 1e-3 of a level plus the
    gap), must be rare (at most 1e-3 of the parameters), and the element
    is left out of the later comparisons. Each step moves many parameters
    by far more than the tolerance."""
    from grace_tpu_torch.compressors import HomoQSGDCompressor
    monkeypatch.setattr(transform, "LeafKey", _JaxUniformKey)
    scales = []
    negotiate = HomoQSGDCompressor.negotiate

    def spy(self, x, group, rng=None):
        scales.append(float(negotiate(self, x, group, rng=rng)))
        return torch.tensor(scales[-1])

    monkeypatch.setattr(HomoQSGDCompressor, "negotiate", spy)
    p, s = _pruned_jax_resnet()
    prev = _flat(p)
    names = leaf_order(prev)
    gap = _grad_gap(p, s)
    tainted = np.zeros(gap.size, bool)
    for jstate, jl, model, loss, state in _train_both(tmp_path,
                                                      HOMOQSGD4_RING):
        np.testing.assert_allclose(loss, jl, rtol=RTOL)
        level = scales[-1] / 7
        params = dict(model.named_parameters())
        now = _flat(jstate.params)
        got = np.concatenate([params[n].detach().numpy().ravel()
                              for n in names])
        want = np.concatenate([now[n].ravel() for n in names])
        before = np.concatenate([prev[n].ravel() for n in names])
        mem = state.grace.mem[0].numpy()
        jmem = np.asarray(jstate.opt_state[0].mem[0])[0]
        off = ~np.isclose(got, want, rtol=RTOL, atol=ATOL) & ~tainted
        np.testing.assert_allclose(np.abs(got - want)[off], LR * level,
                                   rtol=1e-3)
        assert (np.abs(np.abs(mem - jmem) - level)[off]
                <= 1e-3 * level + gap[off]).all()
        # One level more in the decode lowers both the parameter and the
        # residual.
        np.testing.assert_array_equal(np.sign(got - want)[off],
                                      np.sign(mem - jmem)[off])
        tainted |= off
        keep = ~tainted
        np.testing.assert_allclose(got[keep], want[keep], rtol=RTOL,
                                   atol=ATOL)
        assert (np.abs(mem - jmem)[keep]
                <= ATOL + RTOL * np.abs(jmem[keep]) + gap[keep]).all()
        assert int((np.abs(want - before) > 10 * ATOL).sum()) > 100
        buffers = dict(model.named_buffers())
        for name, v in _flat(jstate.model_state).items():
            np.testing.assert_allclose(buffers[name].numpy(), v,
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        prev = now
        gap = _grad_gap(jax.device_get(jstate.params),
                        jax.device_get(jstate.model_state))
    assert tainted.sum() <= 1e-3 * tainted.size
    assert len(scales) == 2 and state.grace.count == 2
