"""The measured shortlist: timed steps and the measured≤static overlap
sandwich; counterpart of the JAX package's ``tuning/measure.py``.

The static stage prices every candidate at one compute step; this stage
supplies each shortlisted candidate's own, from real timed steps of a
real train step (``train.make_train_step`` with SGD(0.1)) in a process
group. Each candidate sample is bracketed by a dense sample taken moments
before it in the same process (the dense anchor interleaved), never by a
number from another run. A sample is ``warmup`` steps, then
``timed_steps`` steps between two waits for the device
(``torch.cuda.synchronize`` on the card), their mean the step time.

The honesty gate is the **overlap sandwich**: the winner's step is
profiled (``torch.profiler`` through :func:`utils.profiling.trace`) and
the capture's overlap fraction
(:func:`grace_tpu_torch.profiling.analyze_trace`) is held to flow pass
5's static bound over the same config's traced dataflow (+slack). The
tracer cannot run while the measuring process group exists (it owns a
fake default group), so the trace is the one the static stage's flow
audit made, kept for this; :func:`overlap_sandwich` re-runs
``pass_overlap_schedulability`` on it with the measured overlap in its
``meta``.

Models: ``"toy"`` is the audit registry's default parameters (512
floats: the model every static number was priced on) under the audit
model's loss; ``"resnet50"`` prices ResNet-50's 161 leaves, and is
measured by a benchmark, not here (as in the JAX package).
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Any, Dict, List, Optional

import torch

from grace_tpu_torch.tuning.candidates import Candidate
from grace_tpu_torch.tuning.cost import TuneTopology, price_candidate

__all__ = ["MeasureTimeout", "bounded_call", "DENSE_ANCHOR",
           "model_structs", "build_model_step", "measure_shortlist",
           "measuring_group", "overlap_sandwich"]


class MeasureTimeout(RuntimeError):
    """A timed measurement leg exceeded its bounded wait (after every
    retry). Carries ``attempts`` and the final ``timeout_s``."""

    def __init__(self, msg: str, *, attempts: int, timeout_s: float):
        super().__init__(msg)
        self.attempts = attempts
        self.timeout_s = timeout_s


def bounded_call(fn, timeout_s: Optional[float], *, retries: int = 0,
                 label: str = "measurement"):
    """``fn()`` under a watchdog: the caller waits at most ``timeout_s``
    for ``fn`` (on a daemon thread), then tries again with the wait
    doubled, ``retries`` times, then raises :class:`MeasureTimeout`. A
    hung thread cannot be killed from Python: it is abandoned and the
    caller goes on. ``timeout_s=None`` runs ``fn`` inline, unbounded.
    What ``fn`` raises propagates unchanged and is not retried."""
    if timeout_s is None:
        return fn()
    import threading

    wait = float(timeout_s)
    for attempt in range(retries + 1):
        out: List[Any] = []
        err: List[BaseException] = []
        done = threading.Event()

        def run():
            try:
                out.append(fn())
            except BaseException as e:                   # noqa: BLE001
                err.append(e)
            finally:
                done.set()

        threading.Thread(target=run, daemon=True,
                         name=f"grace-measure-{label}-{attempt}").start()
        if done.wait(wait):
            if err:
                raise err[0]
            return out[0]
        if attempt < retries:
            wait *= 2
    raise MeasureTimeout(
        f"{label} exceeded the bounded wait after {retries + 1} attempt(s) "
        f"(final timeout {wait:.1f}s) — abandoning the hung leg and "
        "proceeding", attempts=retries + 1, timeout_s=wait)


DENSE_ANCHOR = Candidate(
    name="dense", source="generated",
    params={"compressor": "none", "memory": "none",
            "communicator": "allreduce", "fusion": "none"})


def model_structs(model: str = "toy"):
    """``{name: (shape, dtype)}`` priced for ``model``: what
    :func:`build_model_step` trains."""
    from grace_tpu_torch.analysis.configs import model_param_structs

    if model == "toy":
        return model_param_structs("default")
    if model == "resnet50":
        return model_param_structs("resnet50")
    raise ValueError(f"unknown model {model!r} — 'toy' or 'resnet50'")


class _Toy(torch.nn.Module):
    """The audit registry's model, ``x @ w + b[:classes]``, its
    parameters drawn from ``rng`` (numpy normals, as the JAX package's)."""

    def __init__(self, rng, device):
        super().__init__()
        from grace_tpu_torch.analysis.trace import default_param_structs
        for name, (shape, _dt) in default_param_structs().items():
            self.register_parameter(name, torch.nn.Parameter(
                torch.from_numpy(rng.normal(size=shape).astype("float32"))
                .to(device)))

    def forward(self, x):
        return x @ self.w + self.b[:self.w.shape[1]]


def _toy_loss(model, batch):
    x, y = batch
    return torch.nn.functional.cross_entropy(model(x), y)


def build_model_step(grace, group=None, model: str = "toy", *,
                     seed: int = 0, per_device_bs: int = 8, device="cuda"):
    """``(step, state, batch)`` of one candidate's real train step over
    ``group`` (None: the default group) on ``device``."""
    import numpy as np

    import torch.distributed as dist

    from grace_tpu_torch.parallel import resolve_device
    from grace_tpu_torch.train import init_train_state, make_train_step

    if model == "resnet50":
        raise NotImplementedError(
            "resnet50 is priced, not measured, by the tuner: its steps run "
            "through a benchmark; the in-process shortlist uses "
            "model='toy'")
    if model != "toy":
        raise ValueError(f"unknown model {model!r}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    net = _Toy(rng, dev)
    dim, classes = net.w.shape
    n = dist.get_world_size(group) * per_device_bs
    x = torch.from_numpy(rng.normal(size=(n, dim)).astype("float32"))
    y = torch.from_numpy(rng.integers(0, classes, size=(n,)))
    tx = grace.transform(seed=seed)
    optimizer = torch.optim.SGD(net.parameters(), lr=0.1)
    state = init_train_state(net, tx, optimizer, group=group)
    step = make_train_step(_toy_loss, tx, group=group)
    return step, state, (x.to(dev), y.to(dev))


def _wait(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Live:
    """One candidate's step, sampled again and again."""

    def __init__(self, cand: Candidate, group, model, seed, device):
        self.grace = cand.build(group=group)
        self.step, self.state, self.batch = build_model_step(
            self.grace, group, model, seed=seed, device=device)
        self.device = self.batch[0].device
        self.steps = 0                  # steps run in samples

    def sample(self, timed_steps: int) -> float:
        """One window's seconds a step (3 warm-up steps first, then 1)."""
        for _ in range(1 if self.steps else 3):
            self.state, _ = self.step(self.state, self.batch)
            self.steps += 1
        _wait(self.device)
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            self.state, loss = self.step(self.state, self.batch)
        _wait(self.device)
        self.steps += timed_steps
        if not bool(torch.isfinite(loss)):
            raise FloatingPointError(f"non-finite loss {loss.item()}")
        return (time.perf_counter() - t0) / timed_steps


@contextlib.contextmanager
def measuring_group(device="cuda"):
    """The process group the measured stage runs in: the default group
    when one exists, else a one-rank group of its own (NCCL on the card,
    gloo on the CPU) for the block's length. Yields ``(group,
    device)``."""
    import torch.distributed as dist

    from grace_tpu_torch.parallel import init_process_group, resolve_device

    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        yield dist.group.WORLD, dev
        return
    group, dev = init_process_group(dev)
    try:
        yield group, dev
    finally:
        dist.destroy_process_group()


def measure_shortlist(shortlisted: List[Candidate], spec: TuneTopology,
                      group=None, *, model: str = "toy",
                      timed_steps: int = 8, repeats: int = 2, seed: int = 0,
                      measure_timeout_s: Optional[float] = None,
                      measure_retries: int = 2, device="cuda",
                      constants=None) -> Dict[str, Any]:
    """Time every shortlisted candidate against the interleaved dense
    anchor over ``group`` (None: the default group) on ``device``; rank
    them by the target projection with each one's own measured step in
    the cost model (compute measured here, wire priced where the run is
    going). Returns ``{"rows", "winner", "skipped", ...}``: each row holds
    the kernels its candidate launched in its samples (``launches``, from
    ``ops.launch_counts()`` around them) over ``steps_run`` steps, warm-up
    steps included. A ``needs_kernel`` candidate is skipped
    off the card. With ``measure_timeout_s``, each candidate's whole leg
    runs under :func:`bounded_call` and a hung one lands in ``skipped``."""
    import torch.distributed as dist

    from grace_tpu_torch import ops
    from grace_tpu_torch.parallel import resolve_device

    dev = resolve_device(device)
    structs = model_structs(model)
    base = _Live(DENSE_ANCHOR, group, model, seed, dev)
    rows: List[Dict[str, Any]] = []
    skipped: List[Dict[str, Any]] = []
    for cand in shortlisted:
        if cand.needs_kernel and dev.type != "cuda":
            skipped.append({"candidate": cand.name, "verdict": "skipped",
                            "reason": "needs_kernel: its CUDA kernel runs "
                                      "on the card; on the CPU the wrapper "
                                      "runs the plain version"})
            continue

        def _measure(cand=cand):
            live = _Live(cand, group, model, seed, dev)
            samples, bsamples, launches = [], [], {}
            for _ in range(repeats):
                bsamples.append(base.sample(timed_steps))
                before = ops.launch_counts()
                samples.append(live.sample(timed_steps))
                for k, v in ops.launch_counts().items():
                    if v - before.get(k, 0):
                        launches[k] = launches.get(k, 0) + v - before[k]
            return live, samples, bsamples, launches

        try:
            live, samples, bsamples, launches = bounded_call(
                _measure, measure_timeout_s, retries=measure_retries,
                label=cand.name)
        except MeasureTimeout as e:
            skipped.append({"candidate": cand.name,
                            "verdict": "measure_timeout", "reason": str(e),
                            "attempts": e.attempts,
                            "timeout_s": e.timeout_s})
            continue
        med = statistics.median(samples)
        base_med = statistics.median(bsamples)
        price = price_candidate(live.grace, structs, spec, base_step_s=med,
                                dense_step_s=base_med, constants=constants)
        rows.append({
            "candidate": cand.name,
            "params": dict(cand.params),
            "measured_step_ms": round(med * 1e3, 4),
            "samples_ms": [round(s * 1e3, 4) for s in samples],
            "baseline_step_ms": round(base_med * 1e3, 4),
            "baseline_samples_ms": [round(s * 1e3, 4) for s in bsamples],
            "measured_speedup_vs_dense": round(base_med / med, 4),
            "same_session": True,
            "launches": launches,
            "steps_run": live.steps,
            "projected_step_ms": price["projected_step_ms"],
            "projected_speedup_vs_dense":
                price["predicted_speedup_vs_dense"],
            "ici_bytes": price["ici_bytes"],
            "dcn_bytes": price["dcn_bytes"],
        })
    winner = (min(rows, key=lambda r: (r["projected_step_ms"],
                                       r["candidate"]))["candidate"]
              if rows else None)
    return {"rows": rows, "winner": winner, "skipped": skipped,
            "model": model, "timed_steps": timed_steps, "repeats": repeats,
            "measure_timeout_s": measure_timeout_s,
            "measure_retries": measure_retries,
            "measured_world": dist.get_world_size(group),
            "device": str(dev)}


def overlap_sandwich(candidate: Candidate, traced, trace_dir: str,
                     group=None, *, model: str = "toy", steps: int = 3,
                     seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Profile the winner's real step and hold the capture's overlap
    fraction to flow pass 5's static bound over ``traced``, the winner's
    trace from the static stage's flow audit: the pass runs again on it
    with ``meta['measured_overlap']`` set. ``holds`` is False when the
    measured overlap passes the bound by more than the slack."""
    import copy

    from grace_tpu_torch.analysis.flow import (OVERLAP_SLACK,
                                               overlap_summary,
                                               pass_overlap_schedulability)
    from grace_tpu_torch.parallel import resolve_device
    from grace_tpu_torch.profiling import analyze_trace
    from grace_tpu_torch.utils.profiling import trace

    dev = resolve_device(device)
    grace = candidate.build(group=group)
    step, state, batch = build_model_step(grace, group, model, seed=seed,
                                          device=dev)
    state, loss = step(state, batch)        # the first step outside
    _wait(dev)
    with trace(str(trace_dir), device=dev):
        for _ in range(steps):
            state, loss = step(state, batch)
    doc = analyze_trace(str(trace_dir)).as_dict()
    measured = doc.get("overlap_fraction")
    judged = copy.copy(traced)
    judged.meta = {**traced.meta, "measured_overlap": measured}
    bound = overlap_summary(judged)["static_overlap_bound"]
    violations = [f.message for f in pass_overlap_schedulability(judged)
                  if "measured overlap" in f.message]
    return {
        "config": candidate.name,
        "measured_overlap": measured,
        "static_overlap_bound": (round(bound, 6) if bound is not None
                                 else None),
        "slack": OVERLAP_SLACK,
        "violations": violations,
        "holds": not violations,
        "profiled_steps": steps,
        "device_lanes_detected": doc.get("device_lanes_detected"),
    }
