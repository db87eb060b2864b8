"""Three training steps of a 12-layer ``tiny`` BERT in the port against the
JAX package, on the CPU.

Twelve layers, because the leaf order differs from a plain sort of the
dotted names once a list holds ten or more layers (``layers.10`` would come
before ``layers.2``): every per-leaf key, plan and state slot rides on that
order. The weights are the JAX package's tree drawn with numpy (order-one
scales, as in ``tests/test_torch_models.py``) and carried across with
``convert.from_jax``; the loss is classification over the first token, on
a one-device mesh and a one-rank gloo group, under the two per-leaf
configurations of the BERT bench (``tools/tpu_bert_bench.py``): Top-K 1%
chunk + residual + allgather (the port's grouped kernel path, plain on the
CPU, against JAX's staged path) and PowerSGD rank 4 + its memory +
allreduce (JAX's Threefry initial Q in both packages). JAX's steps for
both configurations come from one compile (``_jax_steps``). After each step the
losses must agree within ``rtol=1e-5``, every parameter and every GRACE
state slot (residuals, PowerSGD's Q) within ``rtol=1e-4`` and an ``atol``
of 1e-5 times the parameter leaf's largest value (a residual that PowerSGD
leaves at rounding noise is held to its leaf's scale, not its own), and
PowerSGD's Q up to the sign of each column (see ``_column_signs_of``).

The optimizer is SGD (``optax.sgd(0.02)``, ``torch.optim.SGD(lr=0.02)``),
not the example's AdamW: the key bias's gradient is zero in exact
arithmetic (the softmax ignores a shift shared by a row's logits), and
Adam scales each package's rounding noise there to ±lr, a different sign
in each. The AdamW equivalence is pinned on its own in
``tests/test_torch_examples2.py``.
"""

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
from grace_tpu.models import transformer as jt
from grace_tpu.train import (init_stateful_train_state as jax_init_state,
                             make_stateful_train_step as jax_make_step)

from grace_tpu_torch import grace_from_params
from grace_tpu_torch.models import transformer as tt
from grace_tpu_torch.parallel import init_process_group
from grace_tpu_torch.train import init_train_state, make_train_step
from grace_tpu_torch.transform import leaf_order

from test_torch_models import _close_per_leaf, _flat, _load, _jitter

# Three classes: with two, the bias's gradient is (g, -g), a tie in |g|
# that rounding breaks one way in each package under Top-K.
TINY12 = jt.tiny(num_layers=12, num_classes=3)
STEPS, LR, SEQ, BATCH = 3, 0.02, 16, 4
CONFIGS = {
    "topk1pct": {"compressor": "topk", "compress_ratio": 0.01,
                 "topk_algorithm": "chunk", "memory": "residual",
                 "communicator": "allgather", "fusion": "none"},
    "powersgd_r4": {"compressor": "powersgd", "compress_rank": 4,
                    "memory": "powersgd", "communicator": "allreduce",
                    "fusion": "none"},
}


@functools.cache
def _problem():
    params = _jitter(jax.eval_shape(
        lambda: jt.init(jax.random.key(0), TINY12))[0], 21)
    rng = np.random.default_rng(22)
    ids = rng.integers(0, TINY12.vocab_size, (BATCH, SEQ)).astype(np.int32)
    y = rng.integers(0, TINY12.num_classes, (BATCH,)).astype(np.int32)
    return params, ids, y


def _jax_loss(params, mstate, batch):
    ids, y = batch
    logits, _ = jt.apply(params, mstate, ids, cfg=TINY12)
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, y).mean(), mstate


def _port_loss(model, batch):
    ids, y = batch
    return F.cross_entropy(model(ids), y)


def _column_signs_of(got, want):
    """``got`` with each column's sign turned to agree with ``want``'s
    (PowerSGD's Q factor: a QR fixes each column up to its sign, which
    LAPACK takes from values as small as a signed zero, and P·Qᵀ is the
    same either way). Other slots pass through."""
    if got.ndim != 2 or got.shape != want.shape or got.shape[1] > 4:
        return got
    return got * np.where((got * want).sum(0) < 0, -1, 1).astype(got.dtype)


@functools.cache
def _jax_steps():
    """JAX's three steps under every configuration, each configuration's
    ``make_stateful_train_step`` called inside one outer jit: one XLA
    compile, in which the shared forward and backward are traced once.
    Per configuration, per step: the loss, the parameters and the GRACE
    ``mem``/``comp`` slots, as numpy."""
    params, ids, y = _problem()
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    steps, states = [], []
    for name in sorted(CONFIGS):
        jopt = optax.chain(jax_grace_from_params(CONFIGS[name]).transform(
            seed=0), optax.sgd(LR))
        steps.append(jax_make_step(_jax_loss, jopt, mesh, donate=False))
        states.append(jax_init_state(params, {}, jopt, mesh))
    every = jax.jit(lambda ss, b: tuple(f(s, b) for f, s in zip(steps, ss)))
    jbatch = (jnp.asarray(ids), jnp.asarray(y))
    out = {name: [] for name in sorted(CONFIGS)}
    states = tuple(states)
    for _ in range(STEPS):
        res = every(states, jbatch)
        states = tuple(s for s, _ in res)
        for name, (s, loss) in zip(sorted(CONFIGS), res):
            js = s.opt_state[0]
            out[name].append((float(loss), _flat(s.params),
                              [None if m is None else np.asarray(m)
                               for m in js.mem],
                              [None if c is None else np.asarray(c)
                               for c in js.comp]))
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tiny12_train_steps_match_jax(name, tmp_path):
    cfg = CONFIGS[name]
    params, ids, y = _problem()
    model = _load(tt.Transformer(TINY12, device="cpu"), params)
    names = leaf_order(dict(model.named_parameters()))
    group, _ = init_process_group("cpu",
                                  init_method=f"file://{tmp_path}/store")
    try:
        tx = grace_from_params(cfg, group=group).transform(seed=0)
        state = init_train_state(
            model, tx, torch.optim.SGD(model.parameters(), lr=LR), group)
        step = make_train_step(_port_loss, tx, group)
        batch = (torch.from_numpy(ids).long(), torch.from_numpy(y).long())
        for jl, jparams, jmem, jcomp in _jax_steps()[name]:
            state, loss = step(state, batch)
            np.testing.assert_allclose(loss.item(), jl, rtol=1e-5)
            _close_per_leaf({n: q.detach().numpy()
                             for n, q in model.named_parameters()}, jparams)
            for got, want in ((state.grace.mem, jmem),
                              (state.grace.comp, jcomp)):
                assert len(got) == len(want) == len(names) == 150
                assert [g is None for g in got] == [w is None for w in want]
                want = {n: w[0] for n, w in zip(names, want)
                        if w is not None}
                got = {n: _column_signs_of(g.numpy(), want[n])
                       for n, g in zip(names, got) if g is not None}
                _close_per_leaf(got, want, like=jparams)
        assert state.grace.count == STEPS
    finally:
        torch.distributed.destroy_process_group()
