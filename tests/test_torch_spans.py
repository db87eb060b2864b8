"""The span log and the collective counters behind ``trace_stage``: the
train step's nested stages, one ``grace/step`` root a step, parents and
step indices, self time, the log's fixed room, nothing recorded or counted
while disarmed, and on two gloo ranks the counted bytes against what
reaches ``torch.distributed``, the buffer averages, and the guard's
update span."""

import time

import pytest
import torch
import torch.multiprocessing as mp

from grace_tpu_torch.telemetry import counters, scopes, spans
from grace_tpu_torch.telemetry.scopes import match_stage

TOPK1 = {"compressor": "topk", "compress_ratio": 0.01,
         "topk_algorithm": "chunk", "memory": "residual",
         "communicator": "allgather", "fusion": "none"}
BN_LAYERS = 2
TIMEOUT_S = 240


@pytest.mark.parametrize("path,stage", [
    ("grace/step", "grace/step"),
    ("grace/step/grace/forward_backward", "grace/forward_backward"),
    ("grace/step/grace/forward_backward/grace/forward", "grace/forward"),
    ("grace/step/grace/forward_backward/grace/backward", "grace/backward"),
    ("grace/step/grace/buffer_mean", "grace/buffer_mean"),
    ("grace/step/grace/optimizer/grace/apply_updates", "grace/apply_updates"),
    ("grace/step/grace/optimizer/grace/exchange", "grace/exchange"),
    ("grace/step/grace/loss_mean", "grace/loss_mean"),
])
def test_nested_stages_resolve(path, stage):
    assert match_stage(path) == stage
    assert stage in scopes.ALL_STAGES


def _model():
    torch.manual_seed(0)
    return torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3), torch.nn.BatchNorm2d(8), torch.nn.ReLU(),
        torch.nn.Conv2d(8, 8, 3), torch.nn.BatchNorm2d(8), torch.nn.ReLU(),
        torch.nn.Flatten(), torch.nn.Linear(8 * 4 * 4, 4))


def _loss(model, batch):
    return torch.nn.functional.cross_entropy(model(batch[0]), batch[1])


def _batch(rank=0):
    gen = torch.Generator().manual_seed(rank)
    return (torch.randn(4, 3, 8, 8, generator=gen),
            torch.randint(0, 4, (4,), generator=gen))


def _train(group, tx=None, params=TOPK1):
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.train import (init_stateful_train_state,
                                       make_stateful_train_step)

    model = _model()
    tx = tx or grace_from_params(params, group=group).transform(0)
    state = init_stateful_train_state(
        model, tx, torch.optim.SGD(model.parameters(), lr=0.1), group)
    return state, make_stateful_train_step(_loss, tx, group)


@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    spans.disarm()
    counters.disarm()
    torch.distributed.destroy_process_group()


def _log(group, steps, max_steps=None):
    state, step = _train(group)
    spans.arm(max_steps or steps, "cpu")
    for _ in range(steps):
        state, _ = step(state, _batch())
    spans.disarm()
    return spans.collect()


def test_armed_steps_have_one_root_a_step_and_right_parents(group):
    log = _log(group, 3)
    roots = [i for i, s in enumerate(log.spans) if s.parent < 0]
    assert [log.spans[i].name for i in roots] == ["grace/step"] * 3
    assert [log.spans[i].step for i in roots] == [0, 1, 2]
    assert log.steps == 3 and log.dropped == 0
    for i, s in enumerate(log.spans):
        if s.parent >= 0:
            p = log.spans[s.parent]
            assert s.parent < i and p.step == s.step
            assert p.host_start_ns <= s.host_start_ns <= s.host_end_ns \
                <= p.host_end_ns
        assert s.device_start_ns is None and s.device_end_ns is None
    by_name = {}
    for s in log.spans:
        by_name.setdefault(s.name, []).append(s)
    for name in ("grace/forward", "grace/backward"):
        assert [log.spans[s.parent].name for s in by_name[name]] == \
            ["grace/forward_backward"] * 3
    for name in ("grace/forward_backward", "grace/buffer_mean",
                 "grace/optimizer", "grace/loss_mean"):
        assert [log.spans[s.parent].name for s in by_name[name]] == \
            ["grace/step"] * 3
    assert [log.spans[s.parent].name for s in by_name["grace/apply_updates"]
            ] == ["grace/optimizer"] * 3
    assert by_name["grace/exchange"]
    assert log.anchor_error_ns is None


def test_self_time_is_the_duration_less_the_childrens(group):
    log = _log(group, 2)
    own = spans.self_ns(log)
    for i, s in enumerate(log.spans):
        kids = sum(c.host_ns for c in log.spans if c.parent == i)
        assert own[i] == s.host_ns - kids >= 0
    roots = sum(s.host_ns for s in log.spans if s.parent < 0)
    assert sum(own) == roots
    assert spans.host_lead_ms(log) is None


def test_self_time_of_a_written_log():
    s = spans.Span
    log = spans.Log([s("grace/step", -1, 0, 0, 100, 10, 150),
                     s("grace/forward", 0, 0, 10, 40, 20, 60),
                     s("grace/backward", 0, 0, 40, 90, 60, 140)],
                    dropped=0, steps=1, anchor_error_ns=1)
    assert spans.self_ns(log) == [20, 30, 50]
    assert spans.per_step_ms(log, "grace/backward") == pytest.approx(5e-5)
    assert spans.host_lead_ms(log) == pytest.approx(5e-5)
    late = spans.Log([s("grace/backward", -1, 0, 0, 100, 0, 170)],
                     dropped=0, steps=1, anchor_error_ns=1, rank=1)
    assert spans.arrival_skew_ms([log, late]) == pytest.approx(3e-5)


def test_disarmed_nothing_is_recorded_or_counted(group):
    state, step = _train(group)
    counters.arm()
    counters.disarm()
    for _ in range(2):
        state, _ = step(state, _batch())
    assert counters.collective_counts() == {"calls": {}, "bytes": {}}
    assert scopes.SPAN_LOG is None and scopes.STAGE_STACK is None
    spans.arm(1, "cpu")
    assert scopes.STAGE_STACK == [] and scopes.SPAN_LOG is not None
    state, _ = step(state, _batch())
    spans.disarm()
    assert scopes.STAGE_STACK is None and scopes.SPAN_LOG is None
    for _ in range(2):
        state, _ = step(state, _batch())
    got = counters.collective_counts()
    # One step's buffer averages (two a BatchNorm layer) and its loss.
    assert got["calls"][("all_reduce", "grace/buffer_mean")] == 2 * BN_LAYERS
    assert got["calls"][("all_reduce", "grace/loss_mean")] == 1
    assert {s.step for s in spans.collect().spans} == {0}


def test_past_max_steps_records_are_dropped(group):
    full = _log(group, 1)
    per_step = len(full.spans)
    log = _log(group, 4, max_steps=2)
    assert log.steps == 2 and {s.step for s in log.spans} == {0, 1}
    assert len(log.spans) == 2 * per_step and log.dropped == 2 * per_step
    # Spans outside any step fill the room and then drop.
    spans.arm(1, "cpu")
    for _ in range(spans.SPANS_PER_STEP + 5):
        with scopes.trace_stage(scopes.STAGE_EXCHANGE):
            pass
    spans.disarm()
    log = spans.collect()
    assert len(log.spans) == spans.SPANS_PER_STEP and log.dropped == 5


def test_counters_armed_alone_count_by_stage(group):
    state, step = _train(group)
    counters.arm()
    assert scopes.STAGE_STACK == [] and scopes.SPAN_LOG is None
    for _ in range(2):
        state, _ = step(state, _batch())
    counters.disarm()
    assert scopes.STAGE_STACK is None
    got = counters.collective_counts()
    assert got["calls"][("all_reduce", "grace/buffer_mean")] == \
        2 * 2 * BN_LAYERS
    assert got["calls"][("all_reduce", "grace/loss_mean")] == 2
    assert {stage for _, stage in got["calls"]} >= {"grace/exchange"}


def test_profiler_alone_counts_nothing(group):
    from torch.profiler import ProfilerActivity, profile

    state, step = _train(group)
    counters.arm()
    counters.disarm()
    with profile(activities=[ProfilerActivity.CPU]):
        state, _ = step(state, _batch())
    assert counters.collective_counts() == {"calls": {}, "bytes": {}}
    assert scopes.STAGE_STACK is None


def test_counters_arm_once_and_give_the_auditors_stack_back():
    counters.arm()
    try:
        with pytest.raises(RuntimeError, match="already armed"):
            counters.arm()
    finally:
        counters.disarm()
    outer = ["grace/exchange"]
    scopes.STAGE_STACK = outer
    try:
        counters.arm()
        assert scopes.STAGE_STACK is outer
        with scopes.trace_stage(scopes.STAGE_COMPRESS):
            counters.count("all_gather", torch.zeros(3))
        counters.disarm()
        assert scopes.STAGE_STACK is outer == ["grace/exchange"]
    finally:
        scopes.STAGE_STACK = None
    assert counters.collective_counts() == {
        "calls": {("all_gather", "grace/compress"): 1},
        "bytes": {("all_gather", "grace/compress"): 12}}


def test_arm_refuses_a_second_log_and_empty_room(group):
    spans.arm(1)
    with pytest.raises(RuntimeError, match="already armed"):
        spans.arm(1)
    spans.disarm()
    with pytest.raises(ValueError):
        spans.arm(0)


# -- two gloo ranks ------------------------------------------------------------

def _worker(rank, init_file, out_dir):
    import torch.distributed as dist

    from grace_tpu_torch import comm, grace_from_params
    from grace_tpu_torch.parallel import init_process_group
    from grace_tpu_torch.resilience import guarded_chain

    group, _ = init_process_group("cpu", rank=rank, world_size=2,
                                  init_method=f"file://{init_file}")
    torch.set_num_threads(1)
    handed = [0]
    gather = comm._all_gather_into

    def seen(out, buf, group=None):
        handed[0] += buf.numel() * buf.element_size()
        return gather(out, buf, group=group)

    comm._all_gather_into = seen
    try:
        state, step = _train(group)
        state, _ = step(state, _batch(rank))
        spans.arm(3, "cpu")
        handed[0] = 0
        for _ in range(3):
            state, _ = step(state, _batch(rank))
        spans.disarm()
        armed = handed[0]
        plain = spans.collect()
        counts = counters.collective_counts()
        logs = spans.gather(plain, group)
        grace = grace_from_params(TOPK1, group=group)
        state, step = _train(group, tx=guarded_chain(grace, seed=0))
        spans.arm(1, "cpu")
        state, _ = step(state, _batch(rank))
        spans.disarm()
        guarded = spans.collect()
        if rank == 0:
            torch.save({"logs": logs, "counts": counts, "handed": armed,
                        "guarded": guarded}, f"{out_dir}/rank0.pt")
        dist.barrier(group=group)
    finally:
        comm._all_gather_into = gather
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spans")
    ctx = mp.start_processes(_worker, args=(str(tmp / "store"), str(tmp)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"two ranks did not finish in {TIMEOUT_S} s")
    return torch.load(tmp / "rank0.pt", weights_only=False)


def test_counted_exchange_bytes_are_the_payloads(two_ranks):
    got = two_ranks["counts"]
    gathered = sum(b for (op, _), b in got["bytes"].items()
                   if op == "all_gather")
    assert gathered == two_ranks["handed"] > 0
    assert {stage for (op, stage) in got["calls"] if op == "all_gather"} \
        == {"grace/exchange"}


def test_buffer_mean_holds_two_all_reduces_a_batchnorm_layer(two_ranks):
    got = two_ranks["counts"]
    assert got["calls"][("all_reduce", "grace/buffer_mean")] == \
        3 * 2 * BN_LAYERS
    assert got["bytes"][("all_reduce", "grace/buffer_mean")] == \
        3 * 2 * BN_LAYERS * 8 * 4            # 8 channels of float32
    assert got["calls"][("all_reduce", "grace/loss_mean")] == 3


def test_guarded_apply_opens_apply_updates(two_ranks):
    log = two_ranks["guarded"]
    apply = [s for s in log.spans if s.name == "grace/apply_updates"]
    assert len(apply) == 1
    assert log.spans[apply[0].parent].name == "grace/optimizer"


def test_ranks_logs_line_up(two_ranks):
    logs = two_ranks["logs"]
    assert [log.rank for log in logs] == [0, 1]
    assert all(log.steps == 3 for log in logs)
    skew = spans.arrival_skew_ms(logs)
    assert skew is not None and 0 <= skew < 10_000
