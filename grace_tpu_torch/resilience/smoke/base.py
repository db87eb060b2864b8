"""The default drill and its variants: LeNet on synthetic MNIST-shaped
data under a per-(step, leaf) NaN implant on one rank
(``ChaosCommunicator``), the guard with its dense escape, the consensus
audit and the telemetry ring, its records in one JSONL artifact.

``--sdc`` adds single-rank parameter corruption (``ChaosParams``) that
the audit must repair; ``--hier`` runs the exchange over the two-level
hierarchical all-reduce; ``--homo`` over the shared-scale homomorphic
QSGD; ``--watch`` swaps the NaNs for a finite single-rank drift that the
watch must attribute within one window while the guard stays silent;
``--pipeline N`` rides the double-buffered packed ring (QSGD q=7 over
``ring``, the quantize-and-pack kernel on the card); ``--lint`` runs the
static auditor over the run's configuration first; ``--profile`` records
the step times and the state footprint. The counterpart of
``tools/chaos_smoke.py``'s ``main``.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from grace_tpu_torch.resilience.smoke.common import (Tape, batch_at, fail,
                                                     finite, in_child, lenet,
                                                     lenet_data, lenet_loss,
                                                     say, world_batch,
                                                     world_of)
from grace_tpu_torch.resilience.smoke.evidence import incident_sink

LINT_PASSES = ("collective_consistency", "bit_exactness",
               "signature_stability", "overlap_schedulability",
               "numeric_safety", "memory_footprint", "rng_lineage",
               "rollback_coverage", "replication_contract")


class KernelTally:
    """The port's kernel launches of each step (the wrappers' counters),
    split by whether the step ran the compressed exchange or the dense
    escape: ``summary()`` gives, a kernel, the total, the launches of the
    first compressed step and of the others, and those of the escape's
    steps."""

    def __init__(self):
        self.steps = []              # (dense, {kernel: launches})
        self._before = None

    def start(self) -> None:
        from grace_tpu_torch import ops
        self._before = ops.launch_counts()

    def stop(self, dense: bool) -> None:
        from grace_tpu_torch import ops
        now = ops.launch_counts()
        self.steps.append((dense, {k: v - self._before.get(k, 0)
                                   for k, v in now.items()
                                   if v - self._before.get(k, 0)}))

    def summary(self) -> dict:
        out = {}
        names = sorted({k for _, d in self.steps for k in d})
        compressed = [d for dense, d in self.steps if not dense]
        for k in names:
            per = [d.get(k, 0) for d in compressed]
            out[k] = {"total": sum(d.get(k, 0) for _, d in self.steps),
                      "compressed_steps": len(per),
                      "first_compressed_step": per[0] if per else 0,
                      "later_compressed_steps": sorted(set(per[1:])),
                      "dense_steps": len(self.steps) - len(per),
                      "dense_launches": sum(d.get(k, 0) for dense, d
                                            in self.steps if dense)}
        return out


def grace_params(args, consensus) -> dict:
    """The run's GRACE configuration, before the chaos wrappers."""
    p = {"compressor": "topk", "compress_ratio": 0.3, "memory": "residual",
         "communicator": "allgather", "escape": "fp16",
         "consensus": consensus,
         # a ring sized to the flush window, so a healthy run never
         # wraps it between flushes
         "telemetry": max(2 * args.telemetry_every, 16)}
    if args.watch:
        p["watch"] = {"window": args.watch_window,
                      "capacity": max(2 * args.telemetry_every
                                      // args.watch_window, 8)}
    if args.homo:
        p.update(compressor="homoqsgd", quantum_num=7)
        p.pop("compress_ratio", None)
    if args.hier:
        p.update(communicator="hier", slice_size=args.slice_size,
                 fusion="flat")
    if args.pipeline > 1:
        # The run rides use_pallas='auto' (the kernel path on the card, the
        # plain versions on the CPU); --lint audits the fused spelling.
        if not (args.homo or args.hier):
            p.update(compressor="qsgd", quantum_num=7, use_pallas="auto",
                     communicator="ring", fusion="flat")
            p.pop("compress_ratio", None)
        p["pipeline"] = args.pipeline
    return p


def _lint_child(conn, params: dict, world: int, device: str) -> None:
    from grace_tpu_torch.analysis import audit_config, run_repo_rules
    findings = run_repo_rules() + audit_config(
        {"name": "chaos_smoke-config", "params": params,
         "passes": LINT_PASSES}, world=world, device=device)
    conn.send([f.as_dict() for f in findings])
    conn.close()


def lint(args, params: dict, sink, group, device) -> int:
    """The static gate before any step: the repository rules and the passes
    over this run's configuration (before the chaos wrappers), traced in a
    process of its own (the auditor's fake world cannot share a process
    with a live group). Findings become ``lint_finding`` records; errors
    fail the drill."""
    lint_params = dict(params)
    if args.pipeline > 1:
        # The fused spelling: the wire kernels' paths inside the audited
        # graph, where flow pass 5 counts the pipeline's chains.
        lint_params["use_pallas"] = True
    findings = in_child(_lint_child, (lint_params, world_of(group),
                                      getattr(device, "type", str(device))),
                        group, preload=("grace_tpu_torch.analysis",))
    if findings is None:
        return fail("graft-lint gave no verdict within its bounded wait")
    if sink is not None:
        for f in findings:
            sink.write({"event": "lint_finding", **f})
    errors = [f for f in findings if f["severity"] == "error"]
    say(f"graft-lint: {len(errors)} error(s), "
        f"{len(findings) - len(errors)} warning(s)")
    if errors:
        for f in errors:
            say(f"  {f['pass']} {f['config']}: {f['message']}")
        return fail("graft-lint found static SPMD hazards — not running "
                    "the chaos matrix on a config that can deadlock a pod")
    return 0


def run(args, argv, group, device) -> int:
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.resilience import (ChaosCommunicator,
                                            ChaosCompressor, ChaosParams,
                                            ConsensusConfig, audit_report,
                                            guarded_chain, replica_variants)
    from grace_tpu_torch.telemetry import (JSONLSink, MultiSink,
                                           TelemetryReader)
    from grace_tpu_torch.train import init_train_state, make_train_step
    from grace_tpu_torch.utils.logging import (ConsensusMonitor,
                                               GuardMonitor, run_provenance)
    from grace_tpu_torch.utils.metrics import guard_report

    world = world_of(group)
    batch = world_batch(args.batch, world)
    images, labels = lenet_data(4 * batch, args.seed)

    consensus = sdc = None
    if args.sdc:
        consensus = ConsensusConfig(audit_every=args.audit_every,
                                    escalate_window=4 * args.audit_every,
                                    escalate_steps=args.fallback_steps)
        sdc_steps = (tuple(int(s) for s in args.sdc_steps.split(","))
                     if args.sdc_steps
                     else (args.steps // 3, 2 * args.steps // 3))
        sdc = ChaosParams(rank=args.sdc_rank, at_steps=sdc_steps,
                          seed=args.seed + 2, group=group)
    if args.watch:
        # The drift must be the only fault: the guard staying silent is
        # part of the claim.
        if args.nan_prob:
            say(f"--watch: disabling NaN injection (nan_prob "
                f"{args.nan_prob} -> 0.0) — the drift scenario requires a "
                "guard-silent run")
        args.nan_prob = 0.0
    if args.homo and args.watch:
        return fail("--homo is incompatible with --watch: the drift "
                    "injector attenuates float payload lanes and the "
                    "homomorphic codec ships integer levels")
    if args.watch and not args.telemetry_out:
        return fail("--watch requires --telemetry-out: the acceptance "
                    "artifact IS the watch_anomaly record")
    params = grace_params(args, consensus)
    grc = grace_from_params(params, group=group)
    grc = dataclasses.replace(grc, communicator=ChaosCommunicator(
        inner=grc.communicator, nan_prob=args.nan_prob, rank=args.rank,
        seed=args.seed + 1))
    if args.watch:
        grc = dataclasses.replace(grc, compressor=ChaosCompressor(
            inner=grc.compressor, drift_scale=args.drift_scale,
            rank=args.watch_rank, seed=args.seed + 3, group=group))
    tx = guarded_chain(grc, fallback_after=args.fallback_after,
                       fallback_steps=args.fallback_steps)

    model = lenet(args.seed, device)
    named = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = init_train_state(model, tx, torch.optim.SGD(
        model.parameters(), lr=args.lr), group)
    step = make_train_step(lenet_loss, tx, group, consensus=consensus)

    tape = Tape()
    sink = reader = None
    if args.telemetry_out:
        prov = run_provenance(
            data="synthetic", tool="chaos_smoke", argv=" ".join(argv),
            nan_prob=args.nan_prob, steps=args.steps,
            fallback_after=args.fallback_after,
            fallback_steps=args.fallback_steps, homo=bool(args.homo))
        sink, _ = incident_sink(JSONLSink(args.telemetry_out,
                                          provenance=prov), args, prov,
                                "watch" if args.watch else "nan")
        sink = MultiSink(sink, tape)
        reader = TelemetryReader(sink, every=args.telemetry_every,
                                 anomaly=args.watch, group=group)
    monitor = GuardMonitor(sink=sink)
    consensus_mon = ConsensusMonitor(sink=sink)
    profiler = None
    if args.profile:
        from grace_tpu_torch.profiling import ProfileRecorder
        profiler = ProfileRecorder(sink=sink, every=args.telemetry_every,
                                   step_fn=step)

    if args.lint:
        rc = lint(args, params, sink, group, device)
        if rc:
            if sink is not None:
                sink.close()
            return rc

    t0 = time.perf_counter()
    loss = float("nan")
    launches = KernelTally() if device.type == "cuda" else None
    dense = False                # the step runs the dense escape
    for i in range(args.steps):
        if sdc is not None:
            state = sdc(state, i)
        b = batch_at(images, labels, batch, i, group, device, clamp=False)
        if launches is not None:
            launches.start()
        if profiler is not None:
            with profiler.step():
                state, loss = step(state, b)
                profiler.sync_on(loss)
            profiler.update(i)
        else:
            state, loss = step(state, b)
        rep = guard_report(state)
        if launches is not None:
            launches.stop(dense)
        dense = bool(rep.get("fallback_active"))
        monitor.update(i, rep)
        if sdc is not None:
            consensus_mon.update(i, audit_report(state))
        if reader is not None:
            reader.update(i, state)
    loss = float(loss)
    dt = time.perf_counter() - t0
    if profiler is not None:
        if args.steps % args.telemetry_every:
            profiler.flush(args.steps - 1)
        profiler.record_state_footprint(state, grc, named, world=world,
                                        step=args.steps - 1)
        arr = profiler.timer.steady * 1e3
        say(f"profiling: step p50 {np.percentile(arr, 50):.1f} ms, p99 "
            f"{np.percentile(arr, 99):.1f} ms over {arr.size} steps | "
            f"kernel builds after the first step {profiler.retraces}")
    if reader is not None:
        reader.flush(state)
        reader.close()
        say(f"telemetry artifact: {args.telemetry_out} ({reader.flushes} "
            f"flushes, {reader.dropped} dropped rows)")

    if launches is not None:
        say(f"kernel launches: {json.dumps(launches.summary())}")
    rep = guard_report(state)
    say(f"{args.steps} steps in {dt:.1f}s | final loss {loss:.4f} | "
        f"skipped {rep['notfinite_count']} | last_bad_step "
        f"{rep['last_bad_step']} | fallback_active {rep['fallback_active']}")

    if not finite(loss):
        return fail("final loss is non-finite — the guard did not contain "
                    "the injected faults")
    if args.watch:
        anomalies = reader.monitor.anomalies if reader.monitor else []
        allowed = {args.watch_rank}
        if sdc is not None:
            # The consensus repair zeroes the SDC rank's residuals, a
            # legitimate residual skew the watch sees.
            allowed.add(args.sdc_rank)
        # Attribution is judged on the codec-health metrics the drift
        # corrupts; grad_norm skews are the fixed shards' heterogeneity.
        fault_metrics = ("compression_error", "residual_norm")
        skews = [a for a in anomalies if a.get("kind") == "skew"
                 and a.get("metric") in fault_metrics]
        hits = [a for a in skews if a.get("rank") == args.watch_rank]
        wrong = [a for a in skews if a.get("rank") not in allowed]
        first = min((a["step"] for a in hits), default=None)
        say(f"watch: {len(anomalies)} anomalies | rank-{args.watch_rank} "
            f"codec-skew hits {len(hits)} (first at step {first}) | "
            f"misattributed {len(wrong)}")
        if rep["notfinite_count"] != 0:
            return fail("guard tripped during the drift scenario — the "
                        "fault is supposed to be finite and "
                        "guard-invisible; the smoke itself is broken")
        if not hits:
            return fail(f"seeded single-rank drift on rank "
                        f"{args.watch_rank} produced no skew "
                        "watch_anomaly for that rank")
        if wrong:
            return fail(f"skew anomalies misattributed to rank(s) "
                        f"{sorted({a['rank'] for a in wrong})}")
        if first > args.watch_window:
            return fail(f"first rank-{args.watch_rank} anomaly at step "
                        f"{first} — later than one watch window "
                        f"({args.watch_window})")
    elif rep["notfinite_count"] == 0:
        return fail("guard never tripped — injection is not reaching the "
                    "pipeline")
    if sdc is not None:
        arep = audit_report(state)
        diverged = replica_variants(state, group)
        say(f"sdc: injected {len(sdc.injections)} | audits "
            f"{arep['audits']} | repairs {arep['repairs']} | escalations "
            f"{arep['escalations']} | replica_variants {diverged}")
        if arep["repairs"] < len(sdc.injections):
            return fail(f"consensus auditor repaired {arep['repairs']} of "
                        f"{len(sdc.injections)} injected corruptions")
        if diverged > 1:
            return fail("param replicas still diverged after the final "
                        "audit window")
    say("OK")
    return 0
