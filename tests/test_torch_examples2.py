"""The port's BERT, CIFAR-10 and synthetic-benchmark examples and their
plumbing against the JAX package and its examples, on the CPU.

* ``bert_routed_rscatter`` (``tools/tpu_bert_bench.py``'s routed Top-K 1%
  chunk reduce-scatter, ``BERT_ROUTE`` verbatim: LayerNorm and bias leaves
  dense fp16 over the all-reduce) on a two-layer ``tiny`` BERT at two gloo
  ranks against JAX's step on a two-device mesh, three SGD steps of a
  classification loss, each rank on its half of the batch: losses within
  ``rtol=1e-5``, parameters and residuals within ``rtol=1e-4`` and 1e-5 of
  the parameter leaf's largest value, the routed leaves keeping no residual.
* The same two ranks run each example once at a tiny size with ``--device
  cpu`` (``bert_powersgd``, ``cifar10_dawn`` with Top-K over the flat
  buffer and its TSV, ``synthetic_benchmark`` on BenchNet): finite losses
  equal on both ranks, the TSV's rows and provenance.
* ``train.warmup_schedule`` at the JAX test's boundary cases
  (``tests/test_resilience.py::test_warmup_boundary_handoff``) and a ramp,
  against JAX's schedule within ``rtol=1e-6``; ``set_lr``.
* ``torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8,
  weight_decay=1e-4)`` is ``optax.adamw(lr)``, and ``SGD(momentum=0.9,
  nesterov=True, weight_decay=wd)`` is ``optax.chain(
  add_decayed_weights(wd), sgd(lr, momentum=0.9, nesterov=True))``, over
  four updates with a changing rate, within ``rtol=1e-6, atol=1e-6``
  (parameters of order one; an update is ~1e-2).
* ``piecewise_linear_lr`` (float32, against JAX's on int32 steps),
  ``augment``, ``synthetic_squad`` and ``synthetic_cifar10`` bit for bit
  against the JAX examples'; the CIFAR-10 binary reader against JAX's on
  two records written here; ``wire_report`` equal to JAX's, path for path.
"""

import functools
import math
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, STEPS, LR, SEQ, BATCH = 2, 3, 0.02, 16, 4
TIMEOUT_S = 300
FP16_DENSE = {"compressor": "fp16", "memory": "none",
              "communicator": "allreduce"}
# tools/tpu_bert_bench.py BERT_ROUTE and bert_routed_rscatter, verbatim.
BERT_ROUTE = [("*ln*", FP16_DENSE), ("*bias*", FP16_DENSE),
              ("*/b", FP16_DENSE)]
ROUTED = {"compressor": "topk", "compress_ratio": 0.01,
          "topk_algorithm": "chunk", "memory": "residual",
          "communicator": "rscatter", "fusion": "none", "route": BERT_ROUTE}
EXAMPLE_ARGS = {
    "bert": ["--device", "cpu", "--size", "tiny", "--seq-len", "16",
             "--batch-size", "4", "--train-size", "8"],
    "cifar": ["--device", "cpu", "--epochs", "2", "--batch-size", "8",
              "--train-size", "16", "--compressor",
              "topk", "--topk-algorithm", "chunk", "--memory", "residual"],
    "bench": ["--device", "cpu", "--model", "benchnet", "--image-size", "32",
              "--batch-size", "2", "--num-classes", "10", "--num-iters", "2",
              "--num-batches-per-iter", "1", "--num-warmup-batches", "1",
              "--compressor", "topk", "--topk-algorithm", "chunk",
              "--memory", "residual", "--fusion", "none"],
}


def _jax_examples():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import bert_powersgd
    import cifar10_dawn
    import common
    return bert_powersgd, cifar10_dawn, common


# -- the routed reduce-scatter at two ranks --------------------------------------

@functools.cache
def _problem():
    from grace_tpu.models import transformer as jt
    from test_torch_models import _jitter
    cfg = jt.tiny(num_classes=3)
    params = _jitter(jax.eval_shape(
        lambda: jt.init(jax.random.key(0), cfg))[0], 31)
    rng = np.random.default_rng(32)
    ids = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    y = rng.integers(0, cfg.num_classes, (BATCH,)).astype(np.int32)
    return cfg, jax.device_get(params), ids, y


def _worker(rank, world, init_file, out_path, tsv_path):
    import torch.distributed as dist
    import torch.nn.functional as F

    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.convert import from_jax
    from grace_tpu_torch.examples import (bert_powersgd, cifar10_dawn,
                                          synthetic_benchmark)
    from grace_tpu_torch.models import transformer as tt
    from grace_tpu_torch.parallel import init_process_group
    from grace_tpu_torch.train import init_train_state, make_train_step
    from grace_tpu_torch.transform import leaf_order

    torch.set_num_threads(1)
    group, dev = init_process_group("cpu", rank=rank, world_size=world,
                                    init_method=f"file://{init_file}")
    out = {}
    try:
        cfg, params, ids, y = _problem()
        model = tt.Transformer(tt.tiny(num_classes=3), device="cpu")
        model.load_state_dict(from_jax(params, {})[0])
        names = leaf_order(dict(model.named_parameters()))
        tx = grace_from_params(ROUTED, group=group).transform(seed=0)
        state = init_train_state(
            model, tx, torch.optim.SGD(model.parameters(), lr=LR), group)
        step = make_train_step(
            lambda m, b: F.cross_entropy(m(b[0]), b[1]), tx, group)
        rows = slice(rank * BATCH // world, (rank + 1) * BATCH // world)
        batch = (torch.from_numpy(ids[rows]).long(),
                 torch.from_numpy(y[rows]).long())
        for s in range(STEPS):
            state, loss = step(state, batch)
            out[f"{s}/loss"] = loss.item()
            for n, q in model.named_parameters():
                out[f"{s}/param/{n}"] = q.detach().numpy().copy()
            for n, m in zip(names, state.grace.mem):
                if m is not None:
                    out[f"{s}/mem/{n}"] = m.numpy().copy()
        quiet = lambda *a, **k: None          # noqa: E731
        ex = bert_powersgd
        res = ex.train(ex.build_parser().parse_args(EXAMPLE_ARGS["bert"]),
                       group, dev, log=quiet)
        out["bert/losses"] = np.array(res["losses"])
        ex = cifar10_dawn
        ex.SYNTHETIC_TEST_SIZE = 8            # a short evaluation
        res = ex.train(ex.build_parser().parse_args(
            EXAMPLE_ARGS["cifar"] + ["--tsv", tsv_path]), group, dev,
            log=quiet)
        out["cifar/losses"] = np.array([r["train loss"] for r in res["rows"]])
        out["cifar/accs"] = np.array([r["test acc"] for r in res["rows"]])
        out["cifar/steps"] = res["steps"]
        out["bench/ips"] = synthetic_benchmark.run(EXAMPLE_ARGS["bench"],
                                                   group, dev)
        dist.barrier(group)
    finally:
        torch.distributed.destroy_process_group()
    np.savez(out_path.format(rank=rank), **out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("bert2"))
    out_path = f"{tmp}/rank{{rank}}.npz"
    tsv = f"{tmp}/cifar.tsv"
    ctx = mp.start_processes(
        _worker, args=(WORLD, f"{tmp}/store", out_path, tsv),
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
    return results, tsv


def _jax_routed_steps():
    from grace_tpu import grace_from_params as jax_grace_from_params
    from grace_tpu.models import transformer as jt
    from grace_tpu.train import init_train_state, make_train_step
    cfg, params, ids, y = _problem()
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    opt = optax.chain(jax_grace_from_params(ROUTED).transform(seed=0),
                      optax.sgd(LR))

    def loss_fn(p, batch):
        logits, _ = jt.apply(p, {}, batch[0], cfg=cfg)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, batch[1]).mean()

    step = make_train_step(loss_fn, opt, mesh, donate=False)
    state = init_train_state(params, opt, mesh)
    batch = jax.device_put((jnp.asarray(ids), jnp.asarray(y)),
                           NamedSharding(mesh, P("data")))
    out = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        out.append((float(loss), state))
    return out


def test_routed_rscatter_matches_jax_at_two_ranks(ranks):
    from test_torch_models import _close_per_leaf, _flat
    results, _ = ranks
    want = _jax_routed_steps()
    for s, (jloss, jstate) in enumerate(want):
        jparams = _flat(jstate.params)
        names = sorted(jparams)
        from grace_tpu_torch.transform import leaf_order
        order = leaf_order(names)
        jmem = {n: np.asarray(m) for n, m in zip(order, jstate.opt_state[0]
                                                   .mem) if m is not None}
        # The routed leaves (LayerNorm, biases) keep no residual.
        assert sorted(jmem) == sorted(n for n in names
                                      if not ("ln" in n or "bias" in n
                                              or n.endswith(".b")))
        for r, res in enumerate(results):
            np.testing.assert_allclose(res[f"{s}/loss"], jloss, rtol=1e-5)
            _close_per_leaf({n: res[f"{s}/param/{n}"] for n in names},
                            jparams)
            got = {k.split("/", 2)[2]: v for k, v in res.items()
                   if k.startswith(f"{s}/mem/")}
            _close_per_leaf(got, {n: m[r] for n, m in jmem.items()},
                            like=jparams)


def test_examples_run_at_two_ranks(ranks):
    results, tsv = ranks
    a, b = results
    for key in ("bert/losses", "cifar/losses", "cifar/accs"):
        assert np.all(np.isfinite(a[key]))
        np.testing.assert_array_equal(a[key], b[key])    # one group mean
    assert len(a["bert/losses"]) == 2                    # 8 seqs / 4
    assert int(a["cifar/steps"]) == 4                    # 2 epochs × 2
    assert np.all((a["cifar/accs"] >= 0) & (a["cifar/accs"] <= 1))
    assert float(a["bench/ips"]) > 0
    with open(tsv) as f:
        lines = f.read().splitlines()
    prov = dict(l[2:].split(": ", 1) for l in lines if l.startswith("# "))
    assert prov["data"] == "synthetic" and prov["compressor"] == "topk"
    assert prov["topk_algorithm"] == "chunk" and prov["world_size"] == "2"
    rows = [l.split("\t") for l in lines if not l.startswith("# ")]
    assert rows[0] == ["epoch", "hours", "top1Accuracy"]
    assert [r[0] for r in rows[1:]] == ["1", "2"]
    assert [float(r[2]) for r in rows[1:]] == pytest.approx(
        [100 * v for v in a["cifar/accs"]], abs=0.005)


# -- schedules and optimizers ---------------------------------------------------

def test_warmup_schedule_matches_jax_at_the_boundaries():
    from grace_tpu.train import warmup_schedule as jax_warmup
    from grace_tpu_torch.train import set_lr, warmup_schedule
    marker = 0.123
    cases = [((0.1, 8, 5, lambda t: marker + 0.01 * t), range(0, 9)),
             ((0.1, 8, 0, None), range(0, 3)),
             ((0.1, 8, 0, lambda t: marker + 1.0 * t), range(0, 3)),
             ((0.05, 4, 7, None), range(0, 12))]
    for (base, world, warm, after), counts in cases:
        got, want = (warmup_schedule(base, world, warm, after),
                     jax_warmup(base, world, warm, after))
        for t in counts:
            np.testing.assert_allclose(got(t), float(want(jnp.int32(t))),
                                       rtol=1e-6, err_msg=str((warm, t)))
    sched = warmup_schedule(0.1, 8, 5, after=lambda t: marker + 0.01 * t)
    assert sched(5) == pytest.approx(marker)        # the hand-off
    assert sched(4) == pytest.approx(0.1 + 0.7 * 4 / 5)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=1.0)
    set_lr(opt, sched, 7)
    assert opt.param_groups[0]["lr"] == pytest.approx(marker + 0.02)


def _optimizer_run(make_torch, jax_tx, lrs):
    rng = np.random.default_rng(40)
    params = {"w": rng.standard_normal((7, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in lrs]
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = make_torch(list(tp.values()))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jax_tx.init(jp)
    for lr, g in zip(lrs, grads):
        for group in opt.param_groups:
            group["lr"] = lr
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        up, jstate = jax_tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   jstate, jp)
        jp = optax.apply_updates(jp, up)
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


LRS = [0.01, 0.03, 0.02, 0.005]


def test_adamw_is_optax_adamw():
    from grace_tpu_torch.examples.bert_powersgd import adamw
    sched = lambda count: jnp.asarray(LRS)[count]       # noqa: E731
    _optimizer_run(lambda ps: adamw(ps, LRS[0]), optax.adamw(sched), LRS)
    # torch's own default decay (1e-2) is not optax's (1e-4).
    assert torch.optim.AdamW([torch.zeros(1)]).defaults["weight_decay"] \
        == 1e-2


def test_nesterov_sgd_with_decay_is_the_optax_chain():
    wd = 5e-4
    sched = lambda count: jnp.asarray(LRS)[count]       # noqa: E731
    _optimizer_run(
        lambda ps: torch.optim.SGD(ps, lr=LRS[0], momentum=0.9,
                                   nesterov=True, weight_decay=wd),
        optax.chain(optax.add_decayed_weights(wd),
                    optax.sgd(sched, momentum=0.9, nesterov=True)), LRS)


# -- the examples' data and schedules, bit for bit --------------------------------

@pytest.mark.parametrize("spe,total", [(16, 24), (3, 24), (7, 4), (5, 1)])
def test_piecewise_linear_lr_is_jax_bit_for_bit(spe, total):
    from grace_tpu_torch.examples.cifar10_dawn import piecewise_linear_lr
    _, jdawn, _ = _jax_examples()
    steps = np.arange(0, spe * total + 2, dtype=np.int32)
    want = [np.float32(jdawn.piecewise_linear_lr(
        jnp.int32(s), spe, total_epochs=total, peak_lr=0.4)) for s in steps]
    got = [np.float32(piecewise_linear_lr(int(s), spe, total_epochs=total,
                                          peak_lr=0.4)) for s in steps]
    np.testing.assert_array_equal(np.array(got).view(np.int32),
                                  np.array(want).view(np.int32))


def test_augment_is_jax_bit_for_bit():
    from grace_tpu_torch.examples.cifar10_dawn import augment
    _, jdawn, _ = _jax_examples()
    x = np.random.default_rng(50).standard_normal(
        (33, 32, 32, 3)).astype(np.float32)
    got = augment(x, np.random.default_rng(51))
    want = jdawn.augment(x, np.random.default_rng(51))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_synthetic_data_is_jax_bit_for_bit():
    from grace_tpu_torch.examples import common
    from grace_tpu_torch.examples.bert_powersgd import synthetic_squad
    from grace_tpu_torch.models import transformer as tt
    jbert, _, jcommon = _jax_examples()
    from grace_tpu.models import transformer as jt
    got = synthetic_squad(64, tt.base(), 384, seed=7)
    want = jbert.synthetic_squad(64, jt.base(), 384, seed=7)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="must be >=16"):
        synthetic_squad(4, tt.tiny(), 15)
    for seed in (0, 43):
        for g, w in zip(common.synthetic_cifar10(40, seed),
                        jcommon.synthetic_cifar10(40, seed)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g.view(np.int32),
                                          w.view(np.int32))
    assert torch.float32 == common.compute_dtype("cpu")
    assert torch.bfloat16 == common.compute_dtype(torch.device("cuda", 0))


def test_cifar10_binary_reader_matches_jax(tmp_path):
    from grace_tpu import data as jdata
    from grace_tpu_torch import data
    _, _, jcommon = _jax_examples()
    rng = np.random.default_rng(60)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
            "test_batch.bin"]:
        rec = rng.integers(0, 256, (2, 3073), dtype=np.uint8)
        rec[:, 0] = rng.integers(0, 10, 2)
        rec.tofile(tmp_path / name)
    for train in (True, False):
        got, want = (data.cifar10_dataset(str(tmp_path), train),
                     jdata.cifar10_dataset(str(tmp_path), train))
        assert got.images.shape == (10 if train else 2, 32, 32, 3)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert (got.mean, got.std) == (want.mean, want.std)
        for g, w in zip(data.load_cifar10_binary(str(tmp_path), train),
                        jcommon.load_cifar10_binary(str(tmp_path), train)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g.view(np.int32) if g.dtype ==
                                          np.float32 else g,
                                          w.view(np.int32) if w.dtype ==
                                          np.float32 else w)


@pytest.mark.parametrize("params", [
    {"compressor": "topk", "compress_ratio": 0.01, "memory": "residual"},
    {"compressor": "qsgd", "quantum_num": 64, "memory": "none"},
    {"compressor": "powersgd", "compress_rank": 4, "memory": "powersgd",
     "communicator": "allreduce"}], ids=["topk", "qsgd", "powersgd"])
def test_wire_report_matches_jax(params):
    from grace_tpu import grace_from_params as jax_grace_from_params
    from grace_tpu.models import transformer as jt
    from grace_tpu.utils.metrics import wire_report as jax_wire_report
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.utils import wire_report
    cfg = jt.tiny(num_layers=12)
    jparams = jax.eval_shape(lambda: jt.init(jax.random.key(0), cfg))[0]
    want = jax_wire_report(jax_grace_from_params(params).compressor, jparams)
    from test_torch_models import _flat_shapes
    shapes = {n: (tuple(s.shape), torch.float32)
              for n, s in _flat_shapes(jparams)}
    got = wire_report(grace_from_params(params).compressor, shapes)
    assert [(l.path, l.dense_bytes, l.wire_bytes) for l in got.leaves] == \
        [(l.path, l.dense_bytes, l.wire_bytes) for l in want.leaves]
    assert got.summary() == want.summary() and str(got) == str(want)
    assert math.isclose(got.ratio, want.ratio)
