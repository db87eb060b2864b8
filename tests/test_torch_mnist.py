"""The port's MNIST convergence path against the JAX package: the data, the
seeded init, LeNet, the training steps, the eval step and a short
convergence floor of the entry point.

* The bundled 8,000/2,000 split, its normalisation and the minibatch order
  are bit-equal to ``grace_tpu.data`` and ``examples/common.py``.
* ``LeNet(seed=s)`` draws ``lenet.init(jax.random.key(s))``'s weights:
  Threefry keys and bits exactly, normals within 4 ulps.
* With JAX's init carried across by ``convert.from_jax``, a 64-image
  batch gives the same loss and gradients within rtol 1e-5 and atol 1e-6,
  and the same logits within rtol 1e-5 and atol 1e-6 times the largest
  logit.
* Three steps of chunk Top-K 1% + residual + allgather (``fusion`` flat
  and none) in a 2-rank gloo group match the JAX package's step on a
  2-device mesh (its staged path: the fused Top-K kernels refuse interpret
  mode on a multi-device mesh) within ``rtol=1e-4, atol=1e-5`` for the
  losses, the parameters and the residuals; ``make_eval_step`` averages as
  JAX's does.
* The entry point at W=2, 3 epochs, reaches test accuracy 0.85 (the JAX
  curve at W=8 reads 0.8890 at epoch 3).

The 2-rank workers are spawned once and run every scenario. The whole
40-epoch curve at W=8 is marked slow.
"""

import functools
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST_DIR = os.path.join(REPO, "examples", "data", "MNIST", "raw")
RTOL, ATOL = 1e-4, 1e-5                   # the reduced ResNet steps' bound
TIMEOUT_S = 300
WORLD = 2
STEPS = 3
LR, MOMENTUM, SEED, BATCH = 0.02, 0.9, 42, 256
TOPK_CHUNK = {"compressor": "topk", "compress_ratio": 0.01,
              "topk_algorithm": "chunk", "memory": "residual",
              "communicator": "allgather"}
FUSIONS = ["flat", "none"]
FLOOR_EPOCHS, FLOOR = 3, 0.85


def _common():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import common
    return common


# -- the data ----------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("split_seed", [0, 1])
def test_split_matches_jax(split_seed, train):
    from grace_tpu import data as jdata
    from grace_tpu_torch import data
    want = jdata.mnist_split_dataset(MNIST_DIR, train, split_seed)
    got = data.mnist_split_dataset(MNIST_DIR, train, split_seed)
    full_x, full_y = jdata._read_idx(MNIST_DIR, train=False)
    sel = data.split_indices(len(full_x), train, split_seed)
    assert len(sel) == (8000 if train else 2000)
    np.testing.assert_array_equal(full_x[sel], want.images)
    np.testing.assert_array_equal(full_y[sel], want.labels)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == want.labels.dtype == np.int32
    assert (got.mean, got.std) == (want.mean, want.std)
    norm = got.normalize(got.images)
    assert norm.dtype == np.float32
    np.testing.assert_array_equal(norm.view(np.int32),
                                  want.normalize(want.images).view(np.int32))
    both = data.split_indices(10000, not train, split_seed)
    assert not set(sel) & set(both)       # disjoint by construction


def test_idx_reader_and_full_set_match_jax():
    from grace_tpu import data as jdata
    from grace_tpu_torch import data
    want = jdata.mnist_dataset(MNIST_DIR, train=False)
    got = data.mnist_dataset(MNIST_DIR, train=False)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    x, y = data.load_mnist_idx(MNIST_DIR, train=False)
    wx, wy = _common().load_mnist_idx(MNIST_DIR, train=False)
    np.testing.assert_array_equal(x.view(np.int32), wx.view(np.int32))
    np.testing.assert_array_equal(y, wy)
    with pytest.raises(FileNotFoundError):
        data.mnist_dataset(MNIST_DIR, train=True)     # no train-* bundled


def test_load_mnist_auto_matches_examples_common():
    from grace_tpu_torch import data
    got = data.load_mnist_auto(MNIST_DIR)
    want = _common().load_mnist_auto(MNIST_DIR)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


@pytest.mark.parametrize("epoch", [1, 2, 40])
def test_minibatch_order_matches_examples_common(epoch):
    from grace_tpu_torch import data
    x = np.arange(8000 * 2, dtype=np.float32).reshape(8000, 2)
    y = np.arange(8000, dtype=np.int32)
    got = list(data.batches(x, y, BATCH, shuffle=True, seed=SEED + epoch))
    want = list(_common().batches(x, y, BATCH, shuffle=True,
                                  seed=SEED + epoch))
    assert len(got) == len(want) == 31
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


# -- the init and the model --------------------------------------------------

def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 5])
def test_threefry_draws_match_jax(seed):
    import jax
    import jax.numpy as jnp
    from grace_tpu_torch.models import threefry as T
    jk, k = jax.random.key(seed), T.key(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jk)),
                                  np.array(k))
    jsplit = [np.asarray(jax.random.key_data(s))
              for s in jax.random.split(jk, 4)]
    split = T.split(k, 4)
    for a, b in zip(jsplit, split):
        np.testing.assert_array_equal(a, np.array(b))
    jsub = jax.random.split(jk, 4)[2]
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jsub, (7, 9), jnp.uint32)),
        T.random_bits(split[2], (7, 9)))
    for shape in [(5, 5, 1, 10), (320, 50), (40000,)]:
        want = np.asarray(jax.random.normal(jsub, shape))
        got = T.normal(split[2], shape)
        assert _ulps(got, want).max() <= 4
        assert np.mean(_ulps(got, want) > 0) < 0.05
    with pytest.raises(ValueError):
        T.key(-1)


@pytest.mark.parametrize("seed", [0, 42])
def test_lenet_init_matches_jax(seed):
    import jax
    from grace_tpu.models import lenet
    from grace_tpu_torch.models.lenet import LeNet
    p, s = lenet.init(jax.random.key(seed))
    assert s == {}
    model = LeNet(device="cpu", seed=seed)
    params = dict(model.named_parameters())
    flat = {".".join(str(q.key) for q in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(p)[0]}
    assert sorted(flat) == sorted(params)
    for name, want in flat.items():
        got = params[name].detach().numpy()
        assert got.shape == want.shape, name
        assert _ulps(got, want).max() <= 4, name
    assert not list(model.buffers())


def _jax_init(seed=SEED):
    import jax
    from grace_tpu.models import lenet
    from grace_tpu_torch.convert import from_jax
    p, _ = lenet.init(jax.random.key(seed))
    sd, _ = from_jax(jax.device_get(p), {})
    return p, sd


def _port_lenet(sd):
    from grace_tpu_torch.models.lenet import LeNet
    model = LeNet(device="cpu")
    model.load_state_dict(sd)                    # strict: every name matches
    return model


def test_lenet_forward_backward_matches_jax():
    import jax
    import jax.numpy as jnp
    import optax
    import torch.nn.functional as F
    from grace_tpu.models import lenet
    from grace_tpu_torch import data
    p, sd = _jax_init()
    model = _port_lenet(sd)
    x, y = data.load_mnist_auto(MNIST_DIR)[:2]
    x, y = x[:64], y[:64]

    def jloss(params):
        logits, _ = lenet.apply(params, {}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), logits

    (loss_j, logits_j), grads_j = jax.value_and_grad(jloss, has_aux=True)(p)
    logits = model(torch.from_numpy(x))
    assert logits.shape == (64, 10)
    loss = F.cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    # A logit is a 50-term product over 320- and 250-term sums, summed in
    # another order by oneDNN than by XLA: a few ulps of the largest
    # partial sum, so its absolute part scales with the largest logit.
    scale = float(np.abs(np.asarray(logits_j)).max())
    assert 1 < scale < 10
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5,
                               atol=1e-6)
    params = dict(model.named_parameters())
    for path, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        name = ".".join(str(q.key) for q in path)
        np.testing.assert_allclose(params[name].grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_flatten_reads_nhwc_order():
    """A flatten of the NCHW activation would feed fc1 its rows in C, H, W
    order: the logits would part from JAX's at once."""
    from grace_tpu_torch.models import layers as L
    _, sd = _jax_init()
    model = _port_lenet(sd)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 28, 28, 1)).astype(np.float32))
    y = x.permute(0, 3, 1, 2)
    for conv in (model.conv1, model.conv2):
        y = torch.relu(L.max_pool(conv(y), 2))
    nchw = model.fc2(torch.relu(model.fc1(y.reshape(4, -1))))
    assert not torch.allclose(nchw, model(x), rtol=1e-2, atol=1e-2)


def test_conv_valid_bias_and_dense_init_match_jax():
    import jax
    import jax.numpy as jnp
    from grace_tpu.models import layers as JL
    from grace_tpu_torch.models import layers as L
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 12, 3)).astype(np.float32)
    p = JL.conv_init(jax.random.key(1), 5, 5, 3, 7, use_bias=True)
    p["b"] = jnp.asarray(rng.standard_normal(7).astype(np.float32))
    want = JL.conv_apply(p, jnp.asarray(x), padding="VALID")
    conv = L.Conv(5, 5, 3, 7, padding="VALID", use_bias=True,
                  generator=torch.Generator())
    conv.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in p.items()})
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert [n for n, _ in L.Conv(3, 3, 2, 2, generator=torch.Generator())
            .named_parameters()] == ["w"]        # ResNet's convs: no bias
    he = L.Dense(4000, 50, init="he", generator=torch.Generator()
                 .manual_seed(0)).w
    glorot = L.Dense(4000, 50, generator=torch.Generator().manual_seed(0)).w
    assert abs(he.std().item() / np.sqrt(2 / 4000) - 1) < 0.02
    assert glorot.abs().max().item() <= np.sqrt(6 / 4050)
    with pytest.raises(ValueError):
        L.Dense(2, 2, init="orthogonal", generator=torch.Generator())
    with pytest.raises(ValueError):
        L.Conv(3, 3, 1, 1, padding="FULL", generator=torch.Generator())


# -- the 2-rank training steps, the eval step and the floor ------------------

def _step_batches():
    """The first STEPS global batches of epoch 1, as the entry point and the
    JAX example draw them."""
    from grace_tpu_torch import data
    x, y = data.load_mnist_auto(MNIST_DIR)[:2]
    return list(data.batches(x, y, BATCH, shuffle=True,
                             seed=SEED + 1))[:STEPS]


def _worker(rank, world, init_file, init_path, out_path):
    import torch.distributed as dist
    import torch.nn.functional as F

    from grace_tpu_torch import data, grace_from_params
    from grace_tpu_torch.examples import mnist10k_lenet as ex
    from grace_tpu_torch.parallel import init_process_group
    from grace_tpu_torch.train import (init_train_state, make_eval_step,
                                       make_train_step)

    torch.set_num_threads(1)
    group, _ = init_process_group("cpu", rank=rank, world_size=world,
                                  init_method=f"file://{init_file}")
    out = {}
    try:
        with np.load(init_path) as f:
            sd = {k: torch.from_numpy(f[k]) for k in f.files}
        local = BATCH // world
        rows = slice(rank * local, (rank + 1) * local)

        def loss_fn(model, batch):
            return F.cross_entropy(model(batch[0]), batch[1])

        for fusion in FUSIONS:
            model = _port_lenet(sd)
            tx = grace_from_params(dict(TOPK_CHUNK, fusion=fusion),
                                   group=group).transform(seed=SEED)
            opt = torch.optim.SGD(model.parameters(), lr=LR,
                                  momentum=MOMENTUM)
            state = init_train_state(model, tx, opt, group)
            step = make_train_step(loss_fn, tx, group)
            for i, (xb, yb) in enumerate(_step_batches()):
                state, loss = step(state, (torch.from_numpy(xb[rows]),
                                           torch.from_numpy(yb[rows]).long()))
                out[f"{fusion}/{i}/loss"] = loss.item()
                for name, p in model.named_parameters():
                    out[f"{fusion}/{i}/param/{name}"] = \
                        p.detach().numpy().copy()
                for j, m in enumerate(state.grace.mem):
                    out[f"{fusion}/{i}/mem/{j}"] = m.numpy().copy()

        def metric_fn(model, batch):
            logits = model(batch[0])
            return {"loss": F.cross_entropy(logits, batch[1]),
                    "acc": (logits.argmax(-1) == batch[1]).float().mean()}

        x_test, y_test = data.load_mnist_auto(MNIST_DIR)[2:]
        share = slice(rank * 1000, (rank + 1) * 1000)
        metrics = make_eval_step(metric_fn, group)(
            _port_lenet(sd), (torch.from_numpy(x_test[share]),
                              torch.from_numpy(y_test[share]).long()))
        out.update({f"eval/{k}": v.item() for k, v in metrics.items()})
        args = ex.build_parser().parse_args(
            ["--device", "cpu", "--compressor", "topk", "--topk-algorithm",
             "chunk", "--memory", "residual", "--epochs", str(FLOOR_EPOCHS)])
        res = ex.train(args, group, "cpu", log=lambda *a: None)
        out["floor/accs"] = np.array(res["accs"])
        out["floor/steps"] = res["steps"]
        dist.barrier(group)
    finally:
        torch.distributed.destroy_process_group()
    np.savez(out_path.format(rank=rank), **out)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mnist"))
    _, sd = _jax_init()
    init_path = f"{tmp}/init.npz"
    np.savez(init_path, **{k: v.numpy() for k, v in sd.items()})
    out_path = f"{tmp}/rank{{rank}}.npz"
    ctx = mp.start_processes(
        _worker, args=(WORLD, f"{tmp}/store", init_path, out_path),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{WORLD}-rank gloo run did not finish in "
                        f"{TIMEOUT_S} s")
    results = []
    for r in range(WORLD):
        with np.load(out_path.format(rank=r)) as f:
            results.append({k: f[k] for k in f.files})
    return results


@functools.cache
def _jax_steps(fusion):
    """The JAX package's STEPS steps on a WORLD-device mesh: per step the
    loss, the parameters and the residuals (leading world axis)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from grace_tpu import grace_from_params
    from grace_tpu.models import lenet
    from grace_tpu.train import init_train_state, make_train_step

    p, _ = _jax_init()
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    cfg = dict(TOPK_CHUNK, fusion=None if fusion == "none" else fusion)
    tx = optax.chain(grace_from_params(cfg).transform(seed=SEED),
                     optax.sgd(LR, momentum=MOMENTUM))

    def loss_fn(params, batch):
        logits, _ = lenet.apply(params, {}, batch[0])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, batch[1]).mean()

    step = make_train_step(loss_fn, tx, mesh, donate=False)
    state = init_train_state(p, tx, mesh)
    out = []
    for xb, yb in _step_batches():
        state, loss = step(state, (jnp.asarray(xb), jnp.asarray(yb)))
        params = {".".join(str(q.key) for q in path): np.asarray(v)
                  for path, v in
                  jax.tree_util.tree_flatten_with_path(state.params)[0]}
        mem = [np.asarray(m) for m in state.opt_state[0].mem]
        out.append((float(loss), params, mem))
    return out


# The leaves whose gradient a max-pool-2 tie flip changes: those upstream of
# the pool but conv2.b (a flip moves a window's gradient to another
# position of the same channel, and the bias sums over positions).
UPSTREAM_OF_POOL2 = ("conv1.b", "conv1.w", "conv2.w")


def _pool2_flips(a, b, batch):
    """Windows of the second max pool whose argmax differs between the port
    model under parameters ``a`` and under ``b`` on ``batch``."""
    import torch.nn.functional as F
    flips = []
    for params in (a, b):
        model = _port_lenet({n: torch.from_numpy(np.array(v))
                             for n, v in params.items()})
        y = model.conv1(torch.from_numpy(batch).permute(0, 3, 1, 2))
        y = torch.relu(F.max_pool2d(y, 2))
        flips.append(F.max_pool2d(model.conv2(y), 2, return_indices=True)[1])
    return int((flips[0] != flips[1]).sum())


@pytest.mark.parametrize("fusion", FUSIONS)
def test_lenet_train_steps_match_jax(fusion, port):
    """Losses, parameters and every rank's residuals within the reduced
    ResNet steps' tolerance. One measured exception: where the port's
    parameters (within ~3e-8 of JAX's) flip a second-pool window whose two
    candidates lie that close, the gradients of the leaves upstream of the
    pool part (up to ~4e-3 in conv2.w at ``fusion='none'``'s third step,
    on rank 1); those leaves are then held on no rank for that step and
    after, and every other leaf still is. The flip is counted here, so the
    exception is taken only where it occurs; at identical parameters the
    two packages' gradients agree (``test_lenet_forward_backward_matches_
    jax``)."""
    want = _jax_steps(fusion)
    batches = _step_batches()
    local = BATCH // WORLD
    names = sorted(want[0][1])                # the leaf order
    flipped, first_flip = set(), None
    prev = {n: np.asarray(v) for n, v in _jax_init()[1].items()}
    port_prev = [dict(prev) for _ in range(WORLD)]
    for i, (jl, jparams, jmem) in enumerate(want):
        xb = batches[i][0]
        flipped |= {r for r in range(WORLD) if _pool2_flips(
            port_prev[r], prev, xb[r * local:(r + 1) * local])}
        if flipped and first_flip is None:
            first_flip = i
        skip = set(UPSTREAM_OF_POOL2) if flipped else set()
        assert len(jmem) == (1 if fusion == "flat" else 8)
        for r in range(WORLD):
            np.testing.assert_allclose(port[r][f"{fusion}/{i}/loss"], jl,
                                       rtol=RTOL)
            for name, v in jparams.items():
                if name not in skip:
                    np.testing.assert_allclose(
                        port[r][f"{fusion}/{i}/param/{name}"], v, rtol=RTOL,
                        atol=ATOL, err_msg=f"step {i} {name}")
            for j, m in enumerate(jmem):
                if r in flipped and (fusion == "flat" or names[j] in skip):
                    continue
                np.testing.assert_allclose(
                    port[r][f"{fusion}/{i}/mem/{j}"].reshape(m[r].shape),
                    m[r], rtol=RTOL, atol=ATOL, err_msg=f"step {i} mem {j}")
            port_prev[r] = {n: port[r][f"{fusion}/{i}/param/{n}"]
                            for n in names}
        prev = jparams
    # The first two steps are held whole, and the parameters moved.
    assert first_flip is None or first_flip >= 2
    first = port[0][f"{fusion}/0/param/fc1.w"]
    assert np.abs(port[0][f"{fusion}/{STEPS - 1}/param/fc1.w"]
                  - first).max() > 10 * ATOL


def test_eval_step_averages_as_jax(port):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from grace_tpu.models import lenet
    from grace_tpu.train import make_eval_step
    from grace_tpu_torch import data

    p, _ = _jax_init()
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))

    def metric_fn(params, batch):
        logits, _ = lenet.apply(params, {}, batch[0], train=False)
        return {"loss": optax.softmax_cross_entropy_with_integer_labels(
                    logits, batch[1]).mean(),
                "acc": jnp.mean(jnp.argmax(logits, -1) == batch[1])}

    x_test, y_test = data.load_mnist_auto(MNIST_DIR)[2:]
    want = make_eval_step(metric_fn, mesh)(
        p, (jnp.asarray(x_test), jnp.asarray(y_test)))
    for r in range(WORLD):
        np.testing.assert_allclose(port[r]["eval/loss"], float(want["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(port[r]["eval/acc"], float(want["acc"]),
                                   rtol=1e-6)
    assert 0.0 < port[0]["eval/acc"] < 0.5               # untrained


def test_entry_point_reaches_the_short_floor(port):
    """The entry point's own init (seed 42) at W=2: 3 epochs of chunk Top-K
    1% + residual, 31 steps each, to test accuracy 0.85 or more."""
    for r in range(WORLD):
        assert int(port[r]["floor/steps"]) == FLOOR_EPOCHS * 31
        np.testing.assert_array_equal(port[r]["floor/accs"],
                                      port[0]["floor/accs"])
    accs = port[0]["floor/accs"]
    assert len(accs) == FLOOR_EPOCHS
    assert accs[-1] >= FLOOR, f"test accuracy {accs} after {FLOOR_EPOCHS} " \
        "epochs"


@pytest.mark.slow
def test_w8_chunk_curve_lands_near_jax(tmp_path):
    """The committed curve's run: 8 gloo ranks, 40 epochs, chunk Top-K 1% +
    residual. JAX's curve reads 0.9790 at epoch 40; the port must land
    within 0.5 pp."""
    from grace_tpu_torch.examples import mnist10k_lenet as ex
    acc = ex.run(["--device", "cpu", "--nproc", "8", "--compressor", "topk",
                  "--topk-algorithm", "chunk", "--memory", "residual",
                  "--tsv", str(tmp_path / "curve.tsv")])
    assert acc >= 0.9740, f"W=8 chunk curve ends at {acc}"

