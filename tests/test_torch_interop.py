"""The port's PyTorch front end: ``GraceBridge`` and ``DistributedOptimizer``.

Every case of the JAX package's ``tests/test_interop.py`` has a counterpart
here, on one rank (a gloo group of one in this process): named-parameter
checks, ``backward_passes_per_step``, the double-backward assertion, the
``zero_grad`` race guard, ``skip_synchronize``, buckets launched during
backward, ``grace_state`` per bucket and the broadcasts. Two spawned gloo
ranks then check what needs a world: the global mean, per-rank residuals,
the broadcasts and the optimizer's agreement across ranks.

Parity: one seeded torch model trains four steps under the JAX package's
``DistributedOptimizer`` and under the port's (none, and Top-K chunk +
residual; one bucket and several). On a one-device JAX mesh the parameters
are equal bit for bit. On the eight-device mesh JAX feeds all eight ranks
the same row, and XLA adds the eight equal values in an order that rounds
(``x + x + x`` is not ``3·x`` in float32), so its mean moves the last bits
of some updates; there the parameters agree within rtol 1e-6.
"""

import os
import subprocess
import sys
import time
import warnings

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from grace_tpu import grace_from_params as jax_grace_from_params
from grace_tpu.interop.torch import \
    DistributedOptimizer as JaxDistributedOptimizer

from grace_tpu_torch import grace_from_params
from grace_tpu_torch.interop import GraceBridge
from grace_tpu_torch.interop.torch import (DistributedOptimizer,
                                           broadcast_optimizer_state,
                                           broadcast_parameters)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = {"compressor": "none", "memory": "none", "communicator": "allreduce"}
TOPK = {"compressor": "topk", "compress_ratio": 0.25, "memory": "residual",
        "communicator": "allgather"}
TOPK_CHUNK = {"compressor": "topk", "compress_ratio": 0.3,
              "topk_algorithm": "chunk", "memory": "residual",
              "communicator": "allgather"}
TIMEOUT_S = 180


@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


def _bridge(cfg, n, group, **kw):
    return GraceBridge(grace_from_params(cfg, group=group), n=n,
                       device="cpu", **kw)


class TestGraceBridge:
    def test_none_allreduce_is_global_mean(self, group):
        bridge = _bridge(DENSE, 16, group)
        g = np.random.default_rng(0).standard_normal((1, 16)).astype(
            np.float32)
        out = bridge.exchange_global(g)
        np.testing.assert_allclose(out.numpy(), g.mean(axis=0), rtol=1e-6)

    def test_topk_residual_state_accumulates(self, group):
        bridge = _bridge(TOPK, 16, group)
        g = np.random.default_rng(0).standard_normal((1, 16)).astype(
            np.float32)
        bridge.exchange_global(g)
        mem = bridge.state.mem[0]
        assert tuple(mem.shape) == (16,)          # this rank's residual
        assert float(mem.abs().sum()) > 0
        assert bridge.state.count == 1

    def test_local_exchange_roundtrip(self, group):
        bridge = _bridge(DENSE, 8, group)
        g = np.arange(8, dtype=np.float32)
        out = bridge.exchange(g)
        assert out.device.type == "cpu" and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), g, rtol=1e-6)

    def test_shape_validation(self, group):
        bridge = _bridge(DENSE, 8, group)
        with pytest.raises(ValueError, match="flat gradients"):
            bridge.exchange(np.zeros(9, np.float32))
        with pytest.raises(ValueError, match="expected"):
            bridge.exchange_global(np.zeros((4, 8), np.float32))

    def test_state_setter_checks_the_layout(self, group):
        bridge = _bridge(TOPK, 8, group)
        bridge.exchange(np.arange(8, dtype=np.float32))
        bridge.state = bridge.state                  # round trip
        other = _bridge(TOPK, 9, group)
        with pytest.raises(ValueError, match="does not match this bridge"):
            bridge.state = other.state

    def test_bridge_defaults_to_the_card(self, group):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GraceBridge(grace_from_params(DENSE, group=group), n=8)


def _toy_model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(10, 16), torch.nn.ReLU(),
                               torch.nn.Linear(16, 3))


def _make_opt(model, group, cfg=None, **kw):
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    return DistributedOptimizer(opt, grace_from_params(cfg or DENSE,
                                                       group=group),
                                named_parameters=model.named_parameters(),
                                group=group, **kw)


def _loss(model, n=4):
    x = torch.randn(n, 10)
    y = torch.randint(0, 3, (n,))
    return torch.nn.functional.cross_entropy(model(x), y)


class TestDistributedOptimizer:
    def test_step_applies_aggregated_grads(self, group):
        model = _toy_model()
        opt = _make_opt(model, group)
        before = [p.detach().clone() for p in model.parameters()]
        _loss(model, 8).backward()
        opt.step()
        assert any(not torch.equal(b, a.detach())
                   for b, a in zip(before, model.parameters()))

    def test_training_converges(self, group):
        model = _toy_model()
        opt = _make_opt(model, group, cfg={**TOPK, "compress_ratio": 0.5})
        torch.manual_seed(1)
        x = torch.randn(64, 10)
        y = (x.sum(dim=1) > 0).long() % 3
        first = None
        for _ in range(40):
            opt.zero_grad()
            loss = torch.nn.functional.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            if first is None:
                first = loss.item()
        assert loss.item() < first * 0.7, (first, loss.item())

    def test_duplicate_names_rejected(self, group):
        model = _toy_model()
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        named = [("same", p) for p in model.parameters()]
        with pytest.raises(ValueError, match="unique"):
            DistributedOptimizer(opt, grace_from_params(DENSE, group=group),
                                 named_parameters=named, group=group)

    def test_unnamed_params_rejected(self, group):
        model = _toy_model()
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        named = list(model.named_parameters())[:-1]
        with pytest.raises(ValueError, match="not named"):
            DistributedOptimizer(opt, grace_from_params(DENSE, group=group),
                                 named_parameters=named, group=group)

    def test_double_backward_asserts(self, group):
        model = _toy_model()
        opt = _make_opt(model, group)
        _loss(model).backward()
        with pytest.raises(AssertionError, match="backward_passes_per_step"):
            _loss(model).backward()
        opt.synchronize()

    def test_backward_passes_per_step_accumulates(self, group):
        model = _toy_model()
        opt = _make_opt(model, group, backward_passes_per_step=2)
        _loss(model).backward()
        assert opt._pending is None       # 1 of 2 passes: not launched
        _loss(model).backward()
        assert opt._pending is not None   # the second pass launched it
        opt.step()

    def test_zero_grad_guard(self, group):
        model = _toy_model()
        opt = _make_opt(model, group)
        _loss(model).backward()
        with pytest.raises(AssertionError, match="race condition"):
            opt.zero_grad()
        opt.step()
        opt.zero_grad()

    def test_skip_synchronize_protocol(self, group):
        model = _toy_model()
        opt = _make_opt(model, group)
        _loss(model).backward()
        opt.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with opt.skip_synchronize():
                opt.step()                # no warning, no second exchange
        _loss(model).backward()
        opt.synchronize()
        with pytest.warns(UserWarning, match="skip_synchronize"):
            opt.step()

    def test_grads_equal_plain_sgd_with_none_compressor(self, group):
        model_a, model_b = _toy_model(), _toy_model()
        model_b.load_state_dict(model_a.state_dict())
        opt_a = _make_opt(model_a, group)
        opt_b = torch.optim.SGD(model_b.parameters(), lr=0.1)
        x = torch.randn(8, 10)
        y = torch.randint(0, 3, (8,))
        for opt, model in ((opt_a, model_a), (opt_b, model_b)):
            torch.nn.functional.cross_entropy(model(x), y).backward()
            opt.step()
        for pa, pb in zip(model_a.parameters(), model_b.parameters()):
            assert torch.equal(pa, pb)

    def test_gradients_are_written_back_in_place(self, group):
        """The aggregate lands in each existing ``p.grad`` tensor."""
        model = _toy_model()
        opt = _make_opt(model, group, cfg=TOPK_CHUNK)
        _loss(model).backward()
        ptrs = [p.grad.data_ptr() for p in model.parameters()]
        opt.synchronize()
        assert ptrs == [p.grad.data_ptr() for p in model.parameters()]


class TestBroadcast:
    def test_broadcast_parameters_single_process_noop(self, group):
        model = _toy_model()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        broadcast_parameters(model.state_dict(), root_rank=0, group=group)
        for k, v in model.state_dict().items():
            assert torch.equal(before[k], v)

    def test_broadcast_optimizer_state_preserves_types(self, group):
        model = _toy_model()
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        model(torch.randn(4, 10)).sum().backward()
        opt.step()
        sd_before = opt.state_dict()
        broadcast_optimizer_state(opt, root_rank=0, group=group)
        sd_after = opt.state_dict()
        g0b, g0a = sd_before["param_groups"][0], sd_after["param_groups"][0]
        assert type(g0a["lr"]) is type(g0b["lr"]) and g0a["lr"] == g0b["lr"]
        assert g0a["momentum"] == g0b["momentum"]
        for k in sd_before["state"]:
            for kk, v in sd_before["state"][k].items():
                if isinstance(v, torch.Tensor):
                    assert torch.equal(v, sd_after["state"][k][kk])


TINY_CAP = 0.3 / 1024        # ~0.3 KiB: the 640 B first weight goes alone


class TestBucketedExchange:
    def test_multiple_buckets_formed(self, group):
        model = _toy_model()
        opt = _make_opt(model, group, bucket_cap_mb=TINY_CAP)
        assert len(opt._buckets) > 1
        assert len(opt._bridges) == len(opt._buckets)
        ids = [id(p) for b in opt._buckets for p in b]
        assert sorted(ids) == sorted(id(p) for p in opt._grace_params)
        # Reverse registration order, each bucket seeded seed + bi.
        assert opt._grace_params == list(reversed(list(model.parameters())))
        assert [b._state.seed for b in opt._bridges] == list(
            range(len(opt._buckets)))

    def test_buckets_launch_during_backward(self, group):
        model = _toy_model()
        opt = _make_opt(model, group, bucket_cap_mb=TINY_CAP)
        _loss(model).backward()
        assert all(p is not None for p in opt._pending_b)
        opt.step()

    def test_bucketed_grads_equal_plain_sgd(self, group):
        model_a, model_b = _toy_model(), _toy_model()
        model_b.load_state_dict(model_a.state_dict())
        opt_a = _make_opt(model_a, group, bucket_cap_mb=TINY_CAP)
        opt_b = torch.optim.SGD(model_b.parameters(), lr=0.1)
        x = torch.randn(8, 10)
        y = torch.randint(0, 3, (8,))
        for opt, model in ((opt_a, model_a), (opt_b, model_b)):
            torch.nn.functional.cross_entropy(model(x), y).backward()
            opt.step()
        for pa, pb in zip(model_a.parameters(), model_b.parameters()):
            assert torch.equal(pa, pb)

    def test_grace_state_roundtrip_per_bucket(self, group):
        model = _toy_model()
        opt = _make_opt(model, group, cfg={**TOPK, "compress_ratio": 0.5},
                        bucket_cap_mb=TINY_CAP)
        _loss(model).backward()
        opt.step()
        state = opt.grace_state
        assert isinstance(state, tuple) and len(state) == len(opt._buckets)
        opt.grace_state = state
        with pytest.raises(ValueError, match="entries"):
            opt.grace_state = state[:1]

    def test_double_backward_asserts_with_buckets(self, group):
        model = _toy_model()
        opt = _make_opt(model, group, bucket_cap_mb=TINY_CAP)
        _loss(model).backward()
        with pytest.raises(AssertionError, match="backward_passes_per_step"):
            _loss(model).backward()
        opt.synchronize()

    def test_set_backward_passes_rejects_inflight_grads(self, group):
        model = _toy_model()
        opt = _make_opt(model, group)
        _loss(model).backward()
        with pytest.raises(AssertionError, match="in flight"):
            opt.set_backward_passes_per_step(2)
        opt.synchronize()
        opt.set_backward_passes_per_step(2)


# -- parity with the JAX package's DistributedOptimizer ----------------------

def _train(opt_factory, steps=4):
    model = _toy_model()
    opt = opt_factory(model, torch.optim.SGD(model.parameters(), lr=0.1))
    gen = torch.Generator().manual_seed(1)
    for _ in range(steps):
        x = torch.randn(8, 10, generator=gen)
        y = torch.randint(0, 3, (8,), generator=gen)
        opt.zero_grad()
        torch.nn.functional.cross_entropy(model(x), y).backward()
        opt.step()
    return [p.detach().clone() for p in model.parameters()], opt


@pytest.mark.parametrize("cap", [None, TINY_CAP], ids=["one_bucket",
                                                       "buckets"])
@pytest.mark.parametrize("cfg", [DENSE, TOPK_CHUNK], ids=["none",
                                                         "topk_chunk"])
@pytest.mark.parametrize("devices", [1, 8])
def test_parameters_equal_the_jax_optimizers(group, mesh, devices, cfg, cap):
    jmesh = mesh if devices == 8 else Mesh(np.array(jax.devices()[:1]),
                                           ("data",))
    want, jopt = _train(lambda m, o: JaxDistributedOptimizer(
        o, jax_grace_from_params(cfg), named_parameters=m.named_parameters(),
        mesh=jmesh, bucket_cap_mb=cap))
    got, opt = _train(lambda m, o: DistributedOptimizer(
        o, grace_from_params(cfg, group=group),
        named_parameters=m.named_parameters(), group=group,
        bucket_cap_mb=cap))
    assert len(opt._buckets) == len(jopt._buckets) == (1 if cap is None
                                                       else 2)
    for g, w in zip(got, want):
        if devices == 1:
            assert torch.equal(g, w)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-7)


# -- two gloo ranks ----------------------------------------------------------

WORLD = 2


def _worker(rank, init_file, out_paths):
    from grace_tpu_torch.parallel import init_process_group

    group, _ = init_process_group("cpu", rank=rank, world_size=WORLD,
                                  init_method=f"file://{init_file}")
    try:
        out = {}
        g = np.random.default_rng(0).standard_normal((WORLD, 16)).astype(
            np.float32)
        out["mean"] = _bridge(DENSE, 16, group).exchange_global(g).numpy()
        bridge = _bridge(TOPK, 16, group)
        bridge.exchange_global(g)
        out["residual"] = bridge.state.mem[0].numpy()
        # Rank 1 starts from other weights and momenta; the broadcasts
        # give it rank 0's, scalars keeping their types.
        torch.manual_seed(rank)
        model = torch.nn.Sequential(torch.nn.Linear(10, 16),
                                    torch.nn.ReLU(), torch.nn.Linear(16, 3))
        opt = torch.optim.SGD(model.parameters(), lr=0.1 * (rank + 1),
                              momentum=0.9)
        model(torch.randn(4, 10)).sum().backward()
        opt.step()
        broadcast_parameters(model.state_dict(), root_rank=0, group=group)
        broadcast_optimizer_state(opt, root_rank=0, group=group)
        lr = opt.param_groups[0]["lr"]
        out["lr"] = np.array([lr, float(type(lr) is float)])
        out["momentum_buffer"] = opt.state_dict()["state"][0][
            "momentum_buffer"].numpy()
        dopt = DistributedOptimizer(
            opt, grace_from_params(TOPK_CHUNK, group=group),
            named_parameters=model.named_parameters(), group=group,
            bucket_cap_mb=TINY_CAP)
        for _ in range(3):
            dopt.zero_grad()
            torch.manual_seed(10 + rank)               # per-rank batches
            _loss(model, 8).backward()
            dopt.step()
        for i, p in enumerate(model.parameters()):
            out[f"param{i}"] = p.detach().numpy()
        np.savez(out_paths[rank], **out)
    finally:
        torch.distributed.destroy_process_group()


def test_two_gloo_ranks(tmp_path):
    """The global mean; per-rank residuals; the broadcasts; and the ranks'
    parameters equal after three steps of per-rank batches (the exchange
    is global)."""
    outs = [tmp_path / f"rank{r}.npz" for r in range(WORLD)]
    ctx = mp.start_processes(
        _worker, args=(str(tmp_path / "store"), [str(o) for o in outs]),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"two-rank gloo run did not finish in {TIMEOUT_S} s")
    res = []
    for o in outs:
        with np.load(o) as data:
            res.append({k: data[k] for k in data.files})
    g = np.random.default_rng(0).standard_normal((WORLD, 16)).astype(
        np.float32)
    for r in range(WORLD):
        np.testing.assert_allclose(res[r]["mean"], g.mean(axis=0),
                                   rtol=1e-6)
        assert res[r]["lr"].tolist() == [0.1, 1.0]
    assert not np.allclose(res[0]["residual"], res[1]["residual"])
    np.testing.assert_array_equal(res[0]["momentum_buffer"],
                                  res[1]["momentum_buffer"])
    for key in res[0]:
        if key.startswith("param"):
            np.testing.assert_array_equal(res[0][key], res[1][key])


# -- the examples ------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["grace_tpu_torch.examples.torch_synthetic_benchmark", "--device", "cpu",
     "--compressor", "topk", "--topk-algorithm", "chunk", "--memory",
     "residual", "--batch-size", "4", "--image-size", "16",
     "--num-classes", "10", "--num-iters", "2", "--num-batches-per-iter",
     "2", "--num-warmup-batches", "1", "--bucket-cap-mb", "0.1"],
    ["grace_tpu_torch.examples.torch_mnist", "--device", "cpu", "--nproc",
     "2", "--epochs", "1", "--train-size", "512", "--fusion", "grouped"],
], ids=["synthetic_benchmark", "mnist_two_ranks"])
def test_examples_run_on_the_cpu(argv):
    out = subprocess.run([sys.executable, "-m"] + argv, cwd=REPO,
                         capture_output=True, text=True, timeout=TIMEOUT_S,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-2000:]
    assert ("Img/sec per process:" in out.stdout
            or "final train loss" in out.stdout), out.stdout


# -- the loggers -------------------------------------------------------------

def test_loggers_print_what_the_jax_packages_print():
    """``TableLogger`` and ``TSVLogger`` render the same rows as the JAX
    package's, character for character."""
    import io

    from grace_tpu.utils import logging as jlog

    from grace_tpu_torch.utils import logging as tlog

    rows = [{"epoch": 1, "train loss": 2.30258, "epoch time": 0.5},
            {"epoch": 2, "train loss": 1.5, "test acc": 0.9},
            {"epoch": 3, "epoch time": 0.25}]
    outs = []
    for mod in (jlog, tlog):
        stream = io.StringIO()
        table = mod.TableLogger(stream=stream)
        for row in rows:
            table.append(row)
        tsv = mod.TSVLogger(provenance={"data": "synthetic"})
        tsv.append({"epoch": 1, "total time": 90.0, "test acc": 0.9375})
        outs.append((stream.getvalue(), str(tsv)))
    assert outs[0] == outs[1]


def test_rank_zero_print_timer_and_provenance(group, capsys):
    from grace_tpu_torch.utils import (Timer, rank_zero_print,
                                       run_provenance)

    rank_zero_print("from rank 0")
    assert capsys.readouterr().out == "from rank 0\n"
    calls = []
    timer = Timer(sync=lambda: calls.append(1))
    first, second = timer(), timer(include_in_total=False)
    assert first >= 0 and second >= 0 and len(calls) == 3
    assert timer.total_time == first
    prov = run_provenance("synthetic", argv="--x")
    assert prov["data"] == "synthetic" and prov["argv"] == "--x"
    assert prov["world_size"] == 1
    assert prov["platform"] == ("gpu" if torch.cuda.is_available()
                                else "cpu")
