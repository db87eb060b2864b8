"""The port's checkpoints, on the CPU: the JAX package's
``tests/test_checkpoint.py`` cases that do not depend on orbax, on the
port's ``torch.save`` store.

* A train state round-trips bit for bit (parameters, BatchNorm-free model
  buffers, the optimizer's momentum, every residual, the telemetry ring
  and the guard's counters), and a resumed run equals an uninterrupted
  one.
* A changed structure names its first leaf; a changed shape or dtype
  names the leaf and both shapes or dtypes; a checkpoint of another
  number of ranks (two gloo ranks saved it) raises
  ``WorldSizeMismatch``.
* Last-known-good: the newest good step, a revoked mark, the record
  surviving a reopen, retention dropping good steps,
  ``divergence_rollback``'s data cursor.
"""

import json
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from grace_tpu_torch import grace_from_params
from grace_tpu_torch.checkpoint import (Checkpointer, WorldSizeMismatch,
                                        divergence_rollback, latest_step,
                                        restore_checkpoint, save_checkpoint,
                                        state_leaves)
from grace_tpu_torch.resilience import guarded_chain
from grace_tpu_torch.train import init_train_state, make_train_step

TOPK = {"compressor": "topk", "compress_ratio": 0.1, "memory": "residual",
        "communicator": "allgather"}
GUARDED = {**TOPK, "escape": "fp16", "telemetry": True}
TIMEOUT_S = 180


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(16, 4))
        self.b = torch.nn.Parameter(torch.zeros(4))

    def forward(self, x):
        return x @ self.w + self.b


def _loss(model, batch):
    x, y = batch
    return torch.mean((model(x) - y) ** 2)


def _batch():
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.standard_normal((32, 16)).astype(
        np.float32)),
            torch.from_numpy(rng.standard_normal((32, 4)).astype(
                np.float32)))


def _setup(group, params=GUARDED, guard=True, momentum=0.9):
    model = _Linear()
    opt = torch.optim.SGD(model.parameters(), lr=1e-2, momentum=momentum)
    grc = grace_from_params(params, group=group)
    tx = guarded_chain(grc, seed=0) if guard else grc.transform(seed=0)
    state = init_train_state(model, tx, opt, group)
    return state, make_train_step(_loss, tx, group), _batch()


def _tensors(state) -> dict:
    return {p: (v.detach().clone() if torch.is_tensor(v) else v)
            for p, (v, _) in state_leaves(state).items()}


def _assert_states_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for path in a:
        if torch.is_tensor(a[path]):
            assert torch.equal(a[path].view(-1).view(torch.uint8),
                               b[path].view(-1).view(torch.uint8)), path
        else:
            assert a[path] == b[path], path


@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


class TestRoundTrip:
    @pytest.mark.parametrize("guard", [False, True])
    def test_full_state_roundtrip(self, group, tmp_path, guard):
        state, step, batch = _setup(group, guard=guard)
        for _ in range(3):
            state, _ = step(state, batch)
        want = _tensors(state)
        save_checkpoint(tmp_path / "ckpt", state, step=3)
        fresh, _, _ = _setup(group, guard=guard)
        restored = restore_checkpoint(tmp_path / "ckpt", fresh)
        _assert_states_equal(_tensors(restored), want)
        grace = restored.grace.inner if guard else restored.grace
        assert grace.count == 3 and grace.telem is not None

    def test_resume_matches_uninterrupted(self, group, tmp_path):
        state, step, batch = _setup(group)
        for _ in range(2):
            state, _ = step(state, batch)
        save_checkpoint(tmp_path / "c", state, step=2)
        for _ in range(3):
            state, _ = step(state, batch)
        cont = _tensors(state)
        resumed, step2, _ = _setup(group)
        resumed = restore_checkpoint(tmp_path / "c", resumed)
        for _ in range(3):
            resumed, _ = step2(resumed, batch)
        _assert_states_equal(_tensors(resumed), cont)

    def test_grace_residual_state_is_saved(self, group, tmp_path):
        state, step, batch = _setup(group, params=TOPK, guard=False)
        for _ in range(2):
            state, _ = step(state, batch)
        assert any(float(m.abs().sum()) > 0 for m in state.grace.mem)
        save_checkpoint(tmp_path / "c", state, step=2)
        files = sorted(p.name for p in (tmp_path / "c" / "2").iterdir())
        assert files == ["meta.json", "rank0.pt", "replicated.pt"]
        per_rank = torch.load(tmp_path / "c" / "2" / "rank0.pt",
                              weights_only=False)
        # Top-K keeps no compressor state and this run no rings: None
        # leaves (the telemetry ring and the watch ring).
        assert sorted(per_rank) == ["grace/comp/0", "grace/comp/1",
                                    "grace/mem/0", "grace/mem/1",
                                    "grace/telem", "grace/watch"]
        assert per_rank["grace/telem"] is None
        assert per_rank["grace/watch"] is None
        restored = restore_checkpoint(
            tmp_path / "c", _setup(group, params=TOPK, guard=False)[0])
        for a, b in zip(restored.grace.mem, state.grace.mem):
            assert torch.equal(a, b)

    def test_manager_keep_and_latest(self, tmp_path):
        tree = {"x": torch.arange(4.0)}
        with Checkpointer(tmp_path / "m", max_to_keep=2) as ckpt:
            for s in (1, 2, 3):
                ckpt.save(s, tree, force=True)
            ckpt.wait()
            assert ckpt.latest_step() == 3
            assert ckpt.all_steps() == [2, 3]
        assert latest_step(tmp_path / "m") == 3
        assert latest_step(tmp_path / "nothing") is None

    def test_save_interval(self, tmp_path):
        ckpt = Checkpointer(tmp_path / "i", save_interval_steps=2)
        assert ckpt.save(1, {"x": torch.ones(1)}) is False
        assert ckpt.save(2, {"x": torch.ones(1)}) is True
        assert ckpt.save(3, {"x": torch.ones(1)}, force=True) is True
        assert ckpt.all_steps() == [2, 3]

    def test_restore_missing_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            restore_checkpoint(tmp_path / "nothing", {"x": torch.zeros(2)})
        with pytest.raises(FileNotFoundError, match="no checkpoint found"):
            Checkpointer(tmp_path / "empty").restore({"x": torch.zeros(2)})


class TestStructureMismatch:
    def test_extra_target_leaf_named(self, tmp_path):
        state = {"params": {"w": torch.ones(4, 2), "b": torch.zeros(2)}}
        save_checkpoint(tmp_path / "c", state, step=1)
        bad = {"params": {"w": torch.ones(4, 2), "b": torch.zeros(2),
                          "momentum": torch.zeros(2)}}
        with pytest.raises(ValueError, match="params/momentum"):
            restore_checkpoint(tmp_path / "c", bad)

    def test_missing_target_leaf_named(self, tmp_path):
        state = {"params": {"w": torch.ones(4, 2)}, "extra": torch.zeros(3)}
        save_checkpoint(tmp_path / "c", state, step=1)
        with pytest.raises(ValueError, match="extra"):
            restore_checkpoint(tmp_path / "c",
                               {"params": {"w": torch.ones(4, 2)}})

    def test_train_state_optimizer_change_named(self, group, tmp_path):
        """Written with SGD, restored into an Adam state: the error names
        an optimizer leaf."""
        state, step, batch = _setup(group, params=TOPK, guard=False)
        state, _ = step(state, batch)
        save_checkpoint(tmp_path / "c", state, step=1)
        model = _Linear()
        grc = grace_from_params(TOPK, group=group)
        adam = init_train_state(model, grc.transform(seed=0),
                                torch.optim.Adam(model.parameters()), group)
        with pytest.raises(ValueError, match="structure mismatch at leaf "
                                             "'optimizer/"):
            restore_checkpoint(tmp_path / "c", adam)

    def test_unstepped_optimizer_takes_the_stored_state(self, group,
                                                        tmp_path):
        """A fresh SGD-momentum optimizer holds no buffer yet; the stored
        one defines it, and the momentum comes back."""
        state, step, batch = _setup(group)
        state, _ = step(state, batch)
        save_checkpoint(tmp_path / "c", state, step=1)
        fresh, _, _ = _setup(group)
        assert not fresh.optimizer.state
        restored = restore_checkpoint(tmp_path / "c", fresh)
        buf = restored.optimizer.state[restored.model.w]["momentum_buffer"]
        assert torch.equal(
            buf, state.optimizer.state[state.model.w]["momentum_buffer"])


class TestLeafMismatch:
    def test_plain_shape_change_names_leaf_and_both_shapes(self, tmp_path):
        save_checkpoint(tmp_path / "c", {"w": torch.ones(4, 2)}, step=1)
        with pytest.raises(ValueError, match="'w'") as ei:
            restore_checkpoint(tmp_path / "c", {"w": torch.ones(2, 4)})
        assert "(4, 2)" in str(ei.value) and "(2, 4)" in str(ei.value)
        assert not isinstance(ei.value, WorldSizeMismatch)

    def test_dtype_change_names_leaf_and_both_dtypes(self, tmp_path):
        save_checkpoint(tmp_path / "c", {"w": torch.ones(4, 2)}, step=1)
        with pytest.raises(ValueError, match="'w'") as ei:
            restore_checkpoint(tmp_path / "c",
                               {"w": torch.ones(4, 2, dtype=torch.int32)})
        assert "float32" in str(ei.value) and "int32" in str(ei.value)


def _save_worker(rank, init_file, ckpt_dir):
    from grace_tpu_torch.parallel import init_process_group

    group, _ = init_process_group("cpu", rank=rank, world_size=2,
                                  init_method=f"file://{init_file}")
    try:
        state, step, batch = _setup(group)
        state, _ = step(state, batch)
        Checkpointer(ckpt_dir, group=group).save(1, state, good=True)
    finally:
        torch.distributed.destroy_process_group()


def test_world_resize_raises_worldsize_mismatch(tmp_path):
    """Two gloo ranks save (a file each for their residuals and ring, one
    for the replicated leaves); one rank restoring it is told so."""
    ctx = mp.start_processes(
        _save_worker, args=(str(tmp_path / "store"), str(tmp_path / "c")),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"two-rank save did not finish in {TIMEOUT_S} s")
    files = sorted(p.name for p in (tmp_path / "c" / "1").iterdir())
    assert files == ["meta.json", "rank0.pt", "rank1.pt", "replicated.pt"]
    assert json.loads((tmp_path / "c" / "last_known_good.json").read_text()
                      ) == {"good_steps": [1]}
    from grace_tpu_torch.parallel import init_process_group
    group, _ = init_process_group(
        "cpu", init_method=f"file://{tmp_path}/store1")
    try:
        target, _, _ = _setup(group)
        with pytest.raises(WorldSizeMismatch,
                           match="checkpoint world 2, target world 1") as ei:
            restore_checkpoint(tmp_path / "c", target)
        assert "grace/inner/" in str(ei.value)
        assert isinstance(ei.value, ValueError)
    finally:
        torch.distributed.destroy_process_group()


class TestLastKnownGood:
    def test_restore_last_good_picks_newest_good(self, tmp_path):
        with Checkpointer(tmp_path / "g", max_to_keep=None) as ckpt:
            for s, good in ((1, True), (2, True), (3, False), (4, None)):
                ckpt.save(s, {"x": torch.full((2,), float(s))}, force=True,
                          good=good)
            assert ckpt.latest_step() == 4
            assert ckpt.last_good_step() == 2
            restored = ckpt.restore_last_good({"x": torch.zeros(2)})
        assert restored["x"].tolist() == [2.0, 2.0]

    def test_good_mark_can_be_revoked(self, tmp_path):
        with Checkpointer(tmp_path / "r", max_to_keep=None) as ckpt:
            ckpt.save(1, {"x": torch.ones(2)}, force=True, good=True)
            ckpt.mark_good(1, False)
            assert ckpt.last_good_step() is None
            with pytest.raises(FileNotFoundError):
                ckpt.restore_last_good({"x": torch.zeros(2)})

    def test_good_record_survives_reopen(self, tmp_path):
        with Checkpointer(tmp_path / "p", max_to_keep=None) as ckpt:
            ckpt.save(7, {"x": torch.ones(2)}, force=True, good=True)
        with Checkpointer(tmp_path / "p", max_to_keep=None) as ckpt:
            assert ckpt.last_good_step() == 7
        assert json.loads((tmp_path / "p" / "last_known_good.json")
                          .read_text()) == {"good_steps": [7]}

    def test_retention_gc_prunes_good_steps(self, tmp_path):
        with Checkpointer(tmp_path / "gc", max_to_keep=2) as ckpt:
            ckpt.save(1, {"x": torch.ones(2)}, force=True, good=True)
            for s in (2, 3):
                ckpt.save(s, {"x": torch.full((2,), float(s))}, force=True,
                          good=False)
            assert 1 not in ckpt.all_steps()
            assert ckpt.last_good_step() is None

    def test_divergence_rollback_skips_the_data_window(self, group,
                                                       tmp_path):
        state, step, batch = _setup(group)
        ckpt = Checkpointer(tmp_path / "d", max_to_keep=None)
        for i in range(4):
            state, _ = step(state, batch)
            if i == 1:
                good = _tensors(state)
                ckpt.save(i, state, good=True)
        ckpt.save(3, state, good=False)
        restored, good_step, resume_at = divergence_rollback(
            ckpt, state, failed_step=3, skip_window=8)
        assert (good_step, resume_at) == (1, 11)
        _assert_states_equal(_tensors(restored), good)
