"""The port's TensorFlow and Keras front ends against the JAX package's.

The port runs at one rank (a gloo group of one in this process, the
exchange on the CPU); the JAX package on a one-device mesh. The same
gradients, drawn from a seed with numpy, go through both exchangers for
three steps with the state carried, under four configurations (none,
Top-K 1% chunk + residual, signSGD, 1-bit + residual), eagerly and under
``tf.function``, with ``None`` entries, ``IndexedSlices``, a lone source
and mixed dtypes, with the state restored before the first exchange and
with the tape wrapped anew each step: bit for bit, except 1-bit, whose two
means are float sums that XLA and torch add in different orders: within
``ONEBIT_RTOL`` (the codec catalog's bound for it). Keras: the wrapped
optimizer keeps its config and rejects a non-optimizer; ``fit`` under
signSGD and 1-bit + residual from one model's initial weights ends within
``FIT_ATOL`` of JAX's; ``load_model`` revives the wrapped optimizer with
its slots; the three callbacks.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

tf = pytest.importorskip("tensorflow")
keras = pytest.importorskip("keras")

from grace_tpu import grace_from_params as jax_grace_from_params  # noqa: E402
from grace_tpu.interop import keras as jax_keras  # noqa: E402
from grace_tpu.interop import tensorflow as jax_tf  # noqa: E402

from grace_tpu_torch import grace_from_params  # noqa: E402
from grace_tpu_torch.interop import keras as port_keras  # noqa: E402
from grace_tpu_torch.interop import tensorflow as port_tf  # noqa: E402

CONFIGS = {
    "none": {"compressor": "none", "memory": "none",
             "communicator": "allreduce"},
    "topk1pct_chunk": {"compressor": "topk", "compress_ratio": 0.01,
                       "topk_algorithm": "chunk", "memory": "residual",
                       "communicator": "allgather"},
    "signsgd": {"compressor": "signsgd", "memory": "none",
                "communicator": "allreduce"},
    "onebit_residual": {"compressor": "onebit", "memory": "residual",
                        "communicator": "allgather"},
}
SHAPES = [(40, 30), (64,), (7, 3)]
STEPS = 3
# 1-bit's means sum floats, in another order than XLA's: a few ulps.
ONEBIT_RTOL = 2e-6
# Keras fit: the exchanges agree bit for bit; the bound covers Keras's own
# float reassociation between two compiled train functions.
FIT_ATOL = 1e-6


@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _grads(step, seed=0):
    rng = np.random.default_rng(seed + 100 * step)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


def _pair(name, group, mesh1):
    cfg = CONFIGS[name]
    jex = jax_tf.TFExchanger(jax_grace_from_params(cfg), mesh=mesh1)
    pex = port_tf.TFExchanger(grace_from_params(cfg, group=group),
                              group=group, device="cpu")
    return jex, pex


def _bits(t):
    return np.asarray(t.numpy()).tobytes()


def _same(got, want, name, *where):
    """Bit for bit; within ONEBIT_RTOL for 1-bit."""
    if name.startswith("onebit"):
        np.testing.assert_allclose(
            np.asarray(got.numpy(), np.float64),
            np.asarray(want.numpy(), np.float64), rtol=ONEBIT_RTOL,
            atol=1e-7, err_msg=str(where))
    else:
        assert _bits(got) == _bits(want), where


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "tf_function"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_exchanger_equals_jax_over_three_steps(group, mesh1, name, graph):
    jex, pex = _pair(name, group, mesh1)

    def call(ex):
        fn = ex.exchange
        if graph:
            fn = tf.function(lambda *gs: ex.exchange(list(gs)))
            return lambda gs: fn(*gs)
        return fn

    jcall, pcall = call(jex), call(pex)
    for step in range(STEPS):
        gs = [tf.constant(g) for g in _grads(step)]
        want, got = jcall(gs), pcall(gs)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype and g.shape == w.shape
            _same(g, w, name, step)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_none_slices_and_mixed_dtypes_equal_jax(group, mesh1, name):
    """``None`` passes through, ``IndexedSlices`` are densified, each
    gradient comes back in its own dtype."""
    jex, pex = _pair(name, group, mesh1)
    for step in range(STEPS):
        g = _grads(step, seed=7)
        rows = tf.IndexedSlices(tf.constant(g[2][:2]), tf.constant([1, 4]),
                                dense_shape=tf.constant([7, 3]))
        gs = [tf.constant(g[0], tf.float64), None,
              tf.constant(g[1], tf.bfloat16), rows]
        want, got = jex.exchange(gs), pex.exchange(gs)
        assert got[1] is None and want[1] is None
        for i in (0, 2, 3):
            assert got[i].dtype == want[i].dtype
            _same(got[i], want[i], name, step, i)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_restored_state_resumes_as_jax(group, mesh1, name):
    """A state taken after one step and assigned to a fresh exchanger before
    its first exchange continues as the uninterrupted run and as JAX."""
    cfg = CONFIGS[name]
    jex, pex = _pair(name, group, mesh1)
    gs0 = [tf.constant(g) for g in _grads(0)]
    jex.exchange(gs0)
    pex.exchange(gs0)
    assert port_tf.TFExchanger(grace_from_params(cfg, group=group),
                               group=group, device="cpu").grace_state is None
    saved_j = jax.device_get(jex.grace_state)
    saved_p = pex.grace_state
    import copy
    saved_p = copy.deepcopy(saved_p)
    gs1 = [tf.constant(g) for g in _grads(1)]
    cont = pex.exchange(gs1)
    j2 = jax_tf.TFExchanger(jax_grace_from_params(cfg), mesh=mesh1)
    j2.grace_state = saved_j
    p2 = port_tf.TFExchanger(grace_from_params(cfg, group=group),
                             group=group, device="cpu")
    p2.grace_state = saved_p                 # queued: no bridge yet
    resumed, want = p2.exchange(gs1), j2.exchange(gs1)
    for c, r, w in zip(cont, resumed, want):
        assert _bits(c) == _bits(r)
        _same(r, w, name)


@pytest.mark.parametrize("name", ["topk1pct_chunk", "onebit_residual"])
def test_tape_wrapped_each_step_shares_the_exchanger(group, mesh1, name):
    """The reference idiom wraps the tape anew every step: both packages
    reuse one exchanger (the residuals advance, equal bit for bit), and an
    equal config built again gets its own."""
    cfg = CONFIGS[name]
    jgrc, pgrc = jax_grace_from_params(cfg), grace_from_params(cfg,
                                                               group=group)
    vs = [tf.Variable(g) for g in _grads(0, seed=3)]

    def step(grc, wrap, **kw):
        with tf.GradientTape() as tape:
            loss = tf.add_n([tf.reduce_sum(v * v * v) for v in vs])
        tape = wrap(tape, grc, **kw)
        return tape.gradient(loss, vs)

    for _ in range(STEPS):
        want = step(jgrc, jax_tf.DistributedGradientTape, mesh=mesh1)
        got = step(pgrc, port_tf.DistributedGradientTape, group=group,
                   device="cpu")
        for w, g in zip(want, got):
            _same(g, w, name)
    ex = port_tf.exchanger_for(pgrc, device="cpu")
    assert ex is port_tf.exchanger_for(pgrc, group=group, device="cpu")
    assert ex._bridge is not None and float(
        ex.grace_state.mem[0].abs().sum()) > 0
    twin = grace_from_params(cfg, group=group)
    assert port_tf.exchanger_for(twin, device="cpu") is not ex


def test_lone_source_gives_a_lone_gradient(group, mesh1):
    v = tf.Variable([1.0, 2.0, 3.0])
    out = {}
    for label, wrap, kw in (
            ("jax", jax_tf.DistributedGradientTape, {"mesh": mesh1}),
            ("port", port_tf.DistributedGradientTape,
             {"group": group, "device": "cpu"})):
        grc = (jax_grace_from_params if label == "jax" else
               (lambda c: grace_from_params(c, group=group)))(
            CONFIGS["none"])
        with tf.GradientTape() as tape:
            loss = tf.reduce_sum(v * v)
        out[label] = wrap(tape, grc, **kw).gradient(loss, v)
    assert not isinstance(out["port"], list)
    assert _bits(out["port"]) == _bits(out["jax"])
    np.testing.assert_allclose(out["port"].numpy(), 2 * v.numpy())


# -- Keras ---------------------------------------------------------------------------

def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((96, 8)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32)
    return x, y


def _model(weights=None):
    m = keras.Sequential([keras.Input((8,)),
                          keras.layers.Dense(16, activation="relu"),
                          keras.layers.Dense(2)])
    if weights is not None:
        m.set_weights(weights)
    return m


def test_wraps_keeps_config_and_rejects_non_optimizers(group):
    grc = grace_from_params(CONFIGS["none"], group=group)
    opt = port_keras.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=0.25, momentum=0.5), grc,
        group=group, device="cpu")
    assert isinstance(opt, keras.optimizers.SGD)
    assert type(opt).__qualname__ == "DistributedSGD"
    assert float(np.asarray(opt.learning_rate)) == 0.25
    assert opt.get_config()["momentum"] == 0.5
    with pytest.raises(TypeError, match="keras optimizer"):
        port_keras.DistributedOptimizer(object(), grc, device="cpu")


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("name,opt", [("signsgd", "sgd"),
                                      ("onebit_residual", "adam")])
def test_fit_three_steps_equals_jax(group, mesh1, name, opt):
    """Three ``fit`` steps from one model's initial weights under JAX's
    and the port's DistributedOptimizer: the weights within FIT_ATOL."""
    x, y = _data()
    keras.utils.set_random_seed(0)
    init = _model().get_weights()

    def make_opt():
        return (keras.optimizers.SGD(0.002) if opt == "sgd"
                else keras.optimizers.Adam(1e-2))

    out = []
    for wrap, kw, grc in (
            (jax_keras.DistributedOptimizer, {"mesh": mesh1},
             jax_grace_from_params(CONFIGS[name])),
            (port_keras.DistributedOptimizer,
             {"group": group, "device": "cpu"},
             grace_from_params(CONFIGS[name], group=group))):
        model = _model(init)
        model.compile(optimizer=wrap(make_opt(), grc, **kw),
                      loss=keras.losses.SparseCategoricalCrossentropy(
                          from_logits=True))
        model.fit(x, y, batch_size=32, epochs=1, shuffle=False, verbose=0)
        out.append(model.get_weights())
    for w, g in zip(*out):
        np.testing.assert_allclose(g, w, rtol=0, atol=FIT_ATOL)
    assert any(not np.array_equal(a, b) for a, b in zip(out[1], init))


def test_load_model_revives_the_optimizer_with_its_slots(group, tmp_path):
    x, y = _data()
    model = _model()
    model.compile(optimizer=keras.optimizers.SGD(0.1, momentum=0.9),
                  loss=keras.losses.SparseCategoricalCrossentropy(
                      from_logits=True))
    model.fit(x, y, batch_size=32, epochs=1, verbose=0)
    path = str(tmp_path / "model.keras")
    model.save(path)
    saved = [np.asarray(v) for v in model.optimizer.variables]

    loaded = port_keras.load_model(
        path, grace_from_params(CONFIGS["none"], group=group), group=group,
        device="cpu")
    opt = loaded.optimizer
    assert isinstance(opt, keras.optimizers.SGD)
    assert type(opt).__qualname__ == "DistributedSGD"
    got = [np.asarray(v) for v in opt.variables]
    assert len(got) == len(saved)
    for a, b in zip(got, saved):
        np.testing.assert_array_equal(a, b)
    loaded.fit(x, y, batch_size=32, epochs=1, verbose=0)  # the path is live
    assert opt._grace_exchanger is not None


def test_lr_warmup_ramps_to_world_size():
    model = keras.Sequential([keras.Input((2,)), keras.layers.Dense(1)])
    model.compile(optimizer=keras.optimizers.SGD(0.1), loss="mse")
    lrs = {}
    for label, cls in (("jax", jax_keras.LearningRateWarmupCallback),
                       ("port", port_keras.LearningRateWarmupCallback)):
        model.optimizer.learning_rate = 0.1
        cb = cls(world_size=8, warmup_epochs=4)
        cb.set_model(model)
        cb.on_train_begin()
        lrs[label] = []
        for e in range(6):
            cb.on_epoch_begin(e)
            lrs[label].append(float(np.asarray(
                model.optimizer.learning_rate)))
    assert lrs["port"] == lrs["jax"]
    np.testing.assert_allclose(lrs["port"][0], 0.1 * (1 + 7 / 4), rtol=1e-6)
    np.testing.assert_allclose(lrs["port"][5], 0.8, rtol=1e-6)


def test_metric_average_and_broadcast_are_identities_at_one_rank(group):
    logs = {"loss": 1.25, "accuracy": 0.5, "note": "str"}
    port_keras.MetricAverageCallback(group=group)._average(logs)
    assert logs == {"loss": 1.25, "accuracy": 0.5, "note": "str"}
    v = tf.Variable([[1.0, 2.0]])
    port_tf.broadcast_variables([v], root_rank=0, group=group)
    np.testing.assert_array_equal(np.asarray(v), [[1.0, 2.0]])


def test_broadcast_callback_runs_once(group):
    x = np.zeros((8, 2), np.float32)
    y = np.zeros((8,), np.int32)
    model = keras.Sequential([keras.Input((2,)), keras.layers.Dense(2)])
    model.compile(optimizer=keras.optimizers.SGD(0.1),
                  loss=keras.losses.SparseCategoricalCrossentropy(
                      from_logits=True))
    cb = port_keras.BroadcastGlobalVariablesCallback(root_rank=0,
                                                     group=group)
    calls = []
    orig = port_keras.broadcast_variables
    port_keras.broadcast_variables = lambda *a, **k: calls.append(a)
    try:
        model.fit(x, y, batch_size=4, epochs=1, verbose=0, callbacks=[cb])
    finally:
        port_keras.broadcast_variables = orig
    assert cb._done and len(calls) == 2      # model, then optimizer
