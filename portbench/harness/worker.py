"""One rank of a run.

``run_rank(spec)``: join the process group; build the training step from
the seed (weights and batches drawn on the card); drive it through its
first three steps, which the reference follows later; warm up; run the
window (with ``trace``, its last steps in one profiler session); free the
program; on rank 0 run the reference and compare; rank 0 returns the
result's pieces. ``spec["mode"] == "readings"`` instead reads the
comparison's numbers for many seeds and variants (the program, a planted
fault, the control) with no window, each judged by the cell's limits.
``spec["fault"]`` plants a fault in a run, or with ``control`` compares
the control's readings in the program's place.

A spec holds: ``workload``, ``seed``, ``seconds``, ``trace``, ``rank``,
``world``, ``init_method``, ``device`` (``cuda`` or, in the tests,
``cpu``), ``t0`` (the process start, epoch seconds) and, for readings,
``seeds`` and ``variants``; a test may also pass ``manifest`` and
``bench_dir``.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import math
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from portbench.harness import compare, manifest, trace as tracing

CHECK_STEPS = 3
WARM_STEPS = 5
# A traced run profiles TRACE_WARM steps before its traced window and
# PROFILED_STEPS in it, so that the profiler's start-up falls outside.
TRACE_WARM = 3
PROFILED_STEPS = 20
BANNED = ("jax", "jaxlib", "flax", "optax", "grace_tpu")
FAULTS = ("half_batch", "no_exchange", "unchanged")
# The reference in float8, put in the program's place.
CONTROL = "control"
# The program in float32 with TF32 off: a witness beside the reference.
WITNESS = "program_float32"


def banned_modules() -> List[str]:
    """Modules of JAX or the JAX package loaded in this process, by whole
    top-level name (``grace_tpu_torch`` is not ``grace_tpu``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def stream_seed(seed: int, *parts) -> int:
    """A 63-bit generator seed for one named stream of the run's seed."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)


def generator(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, *parts))


def draw_weights(shapes: Dict[str, tuple], config, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """Every kernel and table (two or more axes) from one normal draw on
    the device, scaled by ``config["init_std"]`` or He's ``sqrt(2 /
    fan_in)``; ``*.scale`` leaves 1, other vectors 0."""
    mats = [n for n, s in shapes.items() if len(s) >= 2]
    flat = torch.randn(sum(math.prod(shapes[n]) for n in mats),
                       generator=generator(device, seed, "weights"),
                       device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        if len(shape) >= 2:
            size = math.prod(shape)
            std = config.get("init_std") or math.sqrt(
                2.0 / math.prod(shape[:-1]))
            out[name] = flat[off:off + size].view(shape).mul_(std)
            off += size
        elif name.endswith("scale"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def draw_batches(cell, seed: int, rank: int, device) -> list:
    ref = cell.reference_model()
    return ref.make_batches(cell.config, int(cell.mix["distinct_batches"]),
                            int(cell.config["batch_per_chip"]),
                            generator(device, seed, "batches", rank), device)


def make_optimizer(spec: Dict[str, Any], params, **extra):
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in spec.items() if k != "name"}
    return getattr(torch.optim, spec["name"])(params, **kwargs, **extra)


def first_update(opt, params: List[torch.Tensor]) -> List[torch.Tensor]:
    """The update each parameter's optimizer got at its first step, from
    its state after that step (zeros where it holds none)."""
    name = type(opt).__name__
    out = []
    for p in params:
        st = opt.state.get(p, {})
        if name == "SGD":
            u = st.get("momentum_buffer")
        elif name in ("Adam", "AdamW"):
            beta1 = opt.param_groups[0]["betas"][0]
            u = None if "exp_avg" not in st else st["exp_avg"] / (1 - beta1)
        else:
            raise ValueError(f"no first-update rule for {name}")
        out.append(torch.zeros_like(p) if u is None else u)
    return out


def norms(ts: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.detach().float().norm() for t in ts])


# -- the program ---------------------------------------------------------------

@dataclasses.dataclass
class Program:
    step: Any
    state: Any
    params: List[torch.Tensor]
    batches: list
    names: List[str]


def build_program(cell, seed: int, device, group, fault: Optional[str]
                  ) -> Program:
    """The port's training step from the seed: the model of
    ``models/<family>.py`` loaded with the drawn weights, the optimizer
    of the configuration, ``grace_from_params(mix).transform(seed)``,
    ``init_stateful_train_state`` and ``make_stateful_train_step``."""
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.train import (init_stateful_train_state,
                                       make_stateful_train_step)

    fam = cell.family()
    shapes = cell.reference_model().param_shapes(cell.config)
    names = list(shapes)
    model = fam.build(cell.config, device)
    named = dict(model.named_parameters())
    got = {n: tuple(p.shape) for n, p in named.items()}
    if got != {n: tuple(s) for n, s in shapes.items()}:
        raise ValueError(f"the port's {cell.config['name']} has parameters "
                         f"{sorted(set(got) ^ set(shapes))} or shapes the "
                         "configuration does not")
    with torch.no_grad():
        for name, w in draw_weights(shapes, cell.config, seed,
                                    device).items():
            named[name].copy_(w)
    opt = make_optimizer(cell.config["optimizer"], model.parameters())
    grace_group = group
    if fault == "no_exchange":
        world = dist.get_world_size(group)
        solos = [dist.new_group([r]) for r in range(world)]
        grace_group = solos[dist.get_rank(group)]
    tx = grace_from_params(cell.mix["grace"], group=grace_group).transform(
        seed & 0x7FFFFFFF)
    state = init_stateful_train_state(model, tx, opt, group)
    step = make_stateful_train_step(
        fam.loss(cell.config, half_batch=fault == "half_batch"), tx, group)
    if fault == "unchanged":
        opt.step = lambda *args, **kwargs: None
    rank = dist.get_rank(group)
    return Program(step, state, [named[n] for n in names],
                   draw_batches(cell, seed, rank, device), names)


def check_steps(prog: Program, cell) -> Dict[str, Any]:
    """Drive the program through its first steps on distinct batches and
    read what the reference will follow (module ``compare``)."""
    from grace_tpu_torch.transform import leaf_order

    start = [p.detach().clone() for p in prog.params]
    losses = []
    update = None
    for i in range(CHECK_STEPS):
        prog.state, loss = prog.step(prog.state, prog.batches[i])
        losses.append(loss)
        if i == 0:
            update = norms(first_update(prog.state.optimizer, prog.params))
    change = norms([p.detach() - s for p, s in zip(prog.params, start)])
    residual = None
    if cell.reference_codec().Codec.has_residual:
        mem = dict(zip(leaf_order(prog.names), prog.state.grace.mem))
        residual = norms([mem[n] for n in prog.names])
    return {"loss": [float(l) for l in losses], "update": update,
            "change": change, "residual": residual}


def gather_readings(readings: Dict[str, Any], group, world: int
                    ) -> Dict[str, Any]:
    """Every rank's leaf norms stacked (R, L), on every rank."""
    out = {"loss": readings["loss"]}
    for key in ("update", "change", "residual"):
        t = readings[key]
        if t is None:
            out[key] = None
            continue
        if world == 1:
            out[key] = t[None].cpu()
            continue
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t, group=group)
        out[key] = torch.stack(parts).cpu()
    return out


# -- the reference -------------------------------------------------------------

def reference_readings(cell, seed: int, world: int, device,
                       precision: str) -> Dict[str, Any]:
    """The plain reference through the same three steps from the same
    weights and every rank's same batches, in ``precision``."""
    from portbench.reference.precision import Precision, no_tf32

    ref = cell.reference_model()
    prec = Precision(precision)
    shapes = ref.param_shapes(cell.config)
    names = list(shapes)
    with no_tf32():
        start = draw_weights(shapes, cell.config, seed, device)
        params = {n: start[n].clone().requires_grad_(True) for n in names}
        leaves = [params[n] for n in names]
        opt = make_optimizer(cell.config["optimizer"], leaves, foreach=False)
        codec = cell.reference_codec().Codec(
            cell.mix["grace"], [shapes[n] for n in names], world, device)
        batches = [draw_batches(cell, seed, r, device)[:CHECK_STEPS]
                   for r in range(world)]
        losses, grad, update = [], None, None
        for i in range(CHECK_STEPS):
            grads, total = [], 0.0
            for r in range(world):
                for p in leaves:
                    p.grad = None
                loss = ref.loss(params, batches[r][i], cell.config, prec)
                loss.backward()
                grads.append([p.grad.detach().clone() for p in leaves])
                total += float(loss.detach())
            upd = codec.exchange(grads)
            if i == 0:
                grad = norms([sum(g) / world for g in zip(*grads)])
                update = norms(upd)
            del grads
            for p, u in zip(leaves, upd):
                p.grad = u
            opt.step()
            losses.append(total / world)
        change = norms([params[n].detach() - start[n] for n in names])
        residual = None
        if codec.has_residual:
            residual = torch.stack([norms(rs) for rs in codec.residuals])
    return {"loss": losses, "grad": grad.cpu(), "update": update.cpu(),
            "change": change.cpu(),
            "residual": None if residual is None else residual.cpu()}


def control_readings(cell, seed: int, world: int, device) -> Dict[str, Any]:
    """The control's readings, shaped as the program's gathered ones."""
    ctl = reference_readings(cell, seed, world, device, "float8")
    ctl["update"] = ctl["update"][None]
    ctl["change"] = ctl["change"][None]
    return ctl


def free_cuda() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# -- a run -----------------------------------------------------------------------

@dataclasses.dataclass
class RunRecord:
    """What the metric readers read (``metrics/<name>.py``)."""

    cell: Any
    world: int
    batch: int
    steps: int
    window_s: float
    setup_s: float
    window_peak_bytes: int
    leaf_sizes: List[int]
    trace: Optional[tracing.Trace] = None
    # A traced run's steps before the profiler started, and their seconds.
    lead_steps: int = 0
    lead_s: float = 0.0


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(prog: Program, spec, device, group, world: int):
    """Warm up, agree on the step count, run the window. Returns
    (steps, window_s, losses, setup_s, trace or None, lead steps, lead
    seconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    d = len(prog.batches)
    k = CHECK_STEPS
    _sync(device)
    t = time.perf_counter()
    for _ in range(WARM_STEPS):
        prog.state, _ = prog.step(prog.state, prog.batches[k % d])
        k += 1
    _sync(device)
    est = (time.perf_counter() - t) / WARM_STEPS
    n = max(1, math.ceil(spec["seconds"] / est))
    if spec["trace"]:
        n = max(n, PROFILED_STEPS + TRACE_WARM + 2)
    agreed = torch.tensor([n], dtype=torch.int64, device=device)
    dist.all_reduce(agreed, op=dist.ReduceOp.MAX, group=group)
    n = int(agreed)
    losses = []
    tracer = window_range = None
    first_profiled = n - PROFILED_STEPS - TRACE_WARM if spec["trace"] else n
    # Set-up's objects leave the collector's generations, so that no full
    # collection over them stalls the host inside the window.
    gc.collect()
    gc.freeze()
    dist.barrier(group=group)
    _sync(device)
    setup_s = time.time() - spec["t0"]
    t_start = time.perf_counter()
    for i in range(n):
        if i == first_profiled:
            _sync(device)
            lead_s = time.perf_counter() - t_start
            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            tracer = profile(activities=acts)
            tracer.__enter__()
        if i == n - PROFILED_STEPS and tracer is not None:
            _sync(device)
            window_range = record_function(tracing.WINDOW_RANGE)
            window_range.__enter__()
        prog.state, loss = prog.step(prog.state, prog.batches[k % d])
        losses.append(loss)
        k += 1
    _sync(device)
    window_s = time.perf_counter() - t_start
    gc.unfreeze()
    traced = None
    if tracer is None:
        lead_s = window_s
    else:
        window_range.__exit__(None, None, None)
        tracer.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            tracer.export_chrome_trace(str(path))
            traced = tracing.load(path, PROFILED_STEPS)
    return n, window_s, losses, setup_s, traced, first_profiled, lead_s


def _max_over(value: float, group, device) -> float:
    t = torch.tensor([float(value)], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t)


def _sum_over(value: float, group, device) -> float:
    t = torch.tensor([float(value)], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return float(t)


def _join(spec):
    from grace_tpu_torch.parallel import init_process_group

    dev = (f"cuda:{spec['rank']}" if spec["device"] == "cuda" else "cpu")
    group, device = init_process_group(
        dev, rank=spec["rank"], world_size=spec["world"],
        init_method=spec.get("init_method"))
    return group, device


def _cell(spec):
    bench_dir = Path(spec.get("bench_dir") or manifest.BENCH_DIR)
    return manifest.resolve(spec["workload"], spec.get("manifest"),
                            bench_dir, spec.get("limits"))


def run_rank(spec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """One rank of one run. Rank 0 returns the result's pieces."""
    if spec.get("mode") == "readings":
        return readings_rank(spec)
    cell = _cell(spec)
    group, device = _join(spec)
    rank, world = spec["rank"], spec["world"]
    fault = spec.get("fault")
    if device.type == "cuda":
        # One process a card and one intra-op thread: the host's cores go
        # to the thread that launches the step.
        torch.set_num_threads(1)
    try:
        prog = build_program(cell, spec["seed"], device, group,
                             None if fault == CONTROL else fault)
        mine = check_steps(prog, cell)
        _sync(device)
        setup_peak = (torch.cuda.max_memory_allocated(device)
                      if device.type == "cuda" else 0)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        steps, window_s, losses, setup_s, traced, lead_steps, lead_s = \
            _window(prog, spec, device, group, world)
        window_peak = (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0)
        failed = int((~torch.isfinite(torch.stack(losses).float())).sum())
        found = banned_modules()
        if found:
            raise SystemExit(f"rank {rank}: loaded {found} by the window's "
                             "close")
        peak = _max_over(max(setup_peak, window_peak), group, device)
        window_peak = _max_over(window_peak, group, device)
        failed = int(_sum_over(failed, group, device))
        busy = window = None
        if traced is not None:
            busy = _sum_over(traced.busy_us() / 1e6, group, device) / world
            window = traced.window_us / 1e6
        readings = gather_readings(mine, group, world)
        names = prog.names
        leaf_sizes = [p.numel() for p in prog.params]
        del prog, losses
        free_cuda()
        result = None
        if rank == 0:
            ref = reference_readings(cell, spec["seed"], world, device,
                                     "float32")
            if fault == CONTROL:
                readings = control_readings(cell, spec["seed"], world,
                                            device)
            found = compare.numbers(readings, ref, names)
            correct, rows = compare.judge(found, cell.limits["limits"])
            record = RunRecord(cell, world, int(cell.config["batch_per_chip"]),
                               steps, window_s, setup_s,
                               int(window_peak), leaf_sizes, traced,
                               lead_steps, lead_s)
            result = {"correct": bool(correct and failed == 0),
                      "attempted": steps, "failed": failed,
                      "record": record, "rows": rows,
                      "memory_peak_bytes": int(peak),
                      "busy_s": busy, "window_s": window}
        dist.barrier(group=group)
        return result
    finally:
        dist.destroy_process_group()


def readings_rank(spec: Dict[str, Any]) -> Optional[List[Dict[str, Any]]]:
    """The comparison's numbers for each of ``spec["seeds"]`` and
    ``spec["variants"]``: ``program`` (sound), each fault of ``FAULTS``
    planted in the program, and ``control`` (the reference in
    float8 in the program's place), each with ``correct`` as the cell's
    limits judge it. No window."""
    cell = _cell(spec)
    group, device = _join(spec)
    rank, world = spec["rank"], spec["world"]
    out = []
    try:
        for seed in spec["seeds"]:
            readings = {}
            for variant in spec["variants"]:
                if variant == CONTROL:
                    continue
                fault = None if variant in ("program", WITNESS) else variant
                if fault is not None and fault not in FAULTS:
                    raise ValueError(f"unknown variant {variant!r}")
                t = time.perf_counter()
                run_cell = cell
                if variant == WITNESS:
                    run_cell = dataclasses.replace(
                        cell, config=dict(cell.config,
                                          compute_dtype="float32"))
                prog = build_program(run_cell, seed, device, group, fault)
                if variant == WITNESS:
                    from portbench.reference.precision import no_tf32
                    with no_tf32():
                        mine = check_steps(prog, cell)
                else:
                    mine = check_steps(prog, cell)
                readings[variant] = gather_readings(mine, group, world)
                names = prog.names
                del prog
                free_cuda()
                if rank == 0:
                    print(f"  seed {seed} {variant}: "
                          f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
            if rank == 0:
                t = time.perf_counter()
                ref = reference_readings(cell, seed, world, device,
                                         "float32")
                ref_s = time.perf_counter() - t
                names = list(cell.reference_model().param_shapes(cell.config))
                if CONTROL in spec["variants"]:
                    readings[CONTROL] = control_readings(cell, seed, world,
                                                         device)
                for variant, got in readings.items():
                    found = compare.numbers(got, ref, names)
                    correct, _ = compare.judge(found, cell.limits["limits"])
                    row = {"seed": seed, "variant": variant,
                           "correct": correct, "reference_s": ref_s,
                           "numbers": {k: v for k, (v, _) in found.items()},
                           "where": {k: w for k, (_, w) in found.items()}}
                    if spec.get("dump"):
                        row["leaves"] = {
                            k: (None if got.get(k) is None else
                                got[k].tolist())
                            for k in ("update", "change", "residual")}
                        row["reference"] = {
                            k: (None if ref.get(k) is None else
                                ref[k].tolist())
                            for k in ("grad", "update", "change",
                                      "residual")}
                        row["loss"] = got["loss"]
                        row["reference_loss"] = ref["loss"]
                        row["names"] = names
                    out.append(row)
                free_cuda()
            dist.barrier(group=group)
        return out if rank == 0 else None
    finally:
        dist.destroy_process_group()
