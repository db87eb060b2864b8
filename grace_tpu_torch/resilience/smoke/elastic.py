"""``--elastic``: the preemption lifecycle, the counterpart of
``tools/chaos_smoke.py``'s ``_elastic_main``.

One rank drifts (finite: the guard must stay silent) until the watch
names it; the :class:`ElasticController` drains (a last-known-good
checkpoint), the rank leaves (its whole slice with ``--hier``: a K→K−1
resize that keeps ``slice_size``) and the survivors train on at W−1 on a
group of their own; then the world grows back: the survivors re-shard
onto the whole group, the departed ranks restore their drained (stale)
checkpoint, and the consensus-gated rejoin barrier must repair them in one
event, replicas bit-identical after. The convergence floor is judged on
the loss after the rejoin. The evidence lands in ``--elastic-out``.

On the port the departed ranks are live processes that sit out the
survivors' phase at a barrier, as a preempted host waits to be
readmitted; every rank calls ``resize_group`` (``dist.new_group``) at the
same point.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from grace_tpu_torch.resilience.smoke.common import (
    Tape, fail, finite, lenet, lenet_data, lenet_loss, rank_of, rows, say,
    shared_dir, world_batch, world_of)
from grace_tpu_torch.resilience.smoke.evidence import (incident_sink,
                                                       write_evidence_doc)

REJOIN_KEYS = ("barrier_repairs", "repairs", "audits", "replica_variants",
               "last_divergent_rank", "fingerprint_bytes", "repair_bytes")


def phases(args):
    """The steps of phase A (full world), B (survivors), C (rejoined)."""
    steps_a = max(args.steps // 3, 2 * args.watch_window)
    steps_b = max(args.steps // 4, 4)
    steps_c = max(args.steps - steps_a - steps_b, 4)
    return steps_a, steps_b, steps_c


def lenet_batches(args, device):
    """``at(w, group)(i)``: step ``i``'s batch of this rank of ``group`` at
    world ``w`` (the JAX drill's data, the same at every world)."""
    images, labels = lenet_data(4 * args.batch, args.seed)

    def at(w, group):
        b = world_batch(args.batch, w)

        def batch(i):
            lo = (i * b) % (len(images) - b + 1)
            part = rows(b, rank_of(group), w, lo)
            return (torch.from_numpy(images[part]).to(device),
                    torch.from_numpy(labels[part].astype(np.int64)).to(
                        device))
        return batch
    return at


def telemetry(args, argv, group, tag: str, **prov_extra):
    """``(sink, reader, tape)`` of a drill with a watch; all None but the
    tape without ``--telemetry-out``."""
    from grace_tpu_torch.telemetry import (JSONLSink, MultiSink,
                                           TelemetryReader)
    from grace_tpu_torch.utils.logging import run_provenance

    tape = Tape()
    if not args.telemetry_out:
        return None, None, tape
    prov = run_provenance(data="synthetic", tool="chaos_smoke",
                          argv=" ".join(argv), steps=args.steps,
                          **prov_extra)
    sink, _ = incident_sink(JSONLSink(args.telemetry_out, provenance=prov),
                            args, prov, tag)
    sink = MultiSink(sink, tape)
    reader = TelemetryReader(sink, every=args.telemetry_every, anomaly=True,
                             group=group)
    return sink, reader, tape


def shrink_and_rejoin(*, args, group, device, controller, ckpt, reader,
                      monitor, state, plan, build, topo_full, at,
                      resize_step: int, steps_a: int, steps_b: int,
                      steps_c: int) -> dict:
    """The lifecycle after the drain, on every rank: the resize to the
    survivors (departed ranks wait), phase B, the grow back (departed ranks
    restore their drained checkpoint), the barrier and phase C. ``build(
    slice_size, region_size, group)`` gives ``(grace, tx)``. Returns the
    results, with ``"error"`` set when an acceptance fact failed."""
    from grace_tpu_torch.resilience import plan_resize, resize_group
    from grace_tpu_torch.train import (TrainState, make_train_step)
    from grace_tpu_torch.utils.metrics import guard_report

    world = plan.old_world
    consensus = controller.consensus
    out = {"error": None}
    ng = resize_group(plan, group)
    if ng is not None:
        grc_b, tx_b = build(plan.topology.slice_size,
                            plan.topology.region_size, ng)
        state_b, resize_down = controller.resize(
            resize_step, state, tx_b, group, ng, plan, grace=grc_b)
        say(f"resize: W{plan.old_world} -> W{plan.new_world} (lost "
            f"{list(plan.lost_ranks)}; slice_size "
            f"{plan.topology.slice_size}, region_size "
            f"{plan.topology.region_size}; whole_slices "
            f"{plan.whole_slices}, whole_regions {plan.whole_regions}; "
            f"footprint_matches {resize_down['footprint_matches']})")
        step_b = make_train_step(lenet_loss, tx_b, ng, consensus=consensus)
        at_b = at(plan.new_world, ng)
        if reader is not None:
            reader.group = ng
        loss_b = float("nan")
        for i in range(steps_a, steps_a + steps_b):
            state_b, loss_b = step_b(state_b, at_b(i))
            if reader is not None:
                reader.update(i, state_b)
        loss_b = float(loss_b)
    else:
        # A departed rank: its event, then it waits for the survivors.
        controller.resize(resize_step, state, None, group, None, plan)
        resize_down, loss_b = {"footprint_matches": None}, 0.0
    # Every rank learns whether the survivors' loss stayed finite.
    verdict = [finite(loss_b) if ng is not None else True]
    gathered = [None] * world
    dist.all_gather_object(gathered, verdict[0], group=group)
    if not all(gathered):
        out["error"] = (f"loss went non-finite at the survivor world "
                        f"W{plan.new_world}")
        return out
    out["resize_down"] = resize_down

    # -- rejoin at the full world behind the consensus barrier ------------
    if reader is not None:
        reader.group = group
    grc_c, tx_c = build(topo_full.slice_size, topo_full.region_size, group)
    grow = dataclasses.replace(plan_resize(world, (), topo_full),
                               old_world=plan.new_world)
    if ng is not None:
        state_c, _ = controller.resize(steps_a + steps_b, state_b, tx_c, ng,
                                       group, grow, grace=grc_c)
        dist.destroy_process_group(ng)
    else:
        # The rejoining rank comes back with the state it drained with:
        # its last-known-good checkpoint, a stale replica.
        controller.resize(steps_a + steps_b, state, None, None, None, grow)
        named = dict(state.model.named_parameters())
        target = TrainState(state.model, torch.optim.SGD(
            state.model.parameters(), lr=args.lr), tx_c.init(named))
        state_c = ckpt.restore_last_good(target)
    state_c, barrier = controller.rejoin(steps_a + steps_b, state_c, group)
    out["barrier"] = barrier
    say(f"rejoin: barrier_repairs {barrier['barrier_repairs']} | "
        f"replica_variants {barrier['replica_variants']} | divergent rank "
        f"{barrier['last_divergent_rank']} | fingerprint "
        f"{barrier['fingerprint_bytes']} B")
    if barrier["barrier_repairs"] != 1:
        out["error"] = (f"rejoin barrier repaired "
                        f"{barrier['barrier_repairs']} times for 1 rejoin "
                        "event — repairs must equal rejoins")
        return out
    if barrier["replica_variants"] != 1:
        out["error"] = "replicas not bit-identical after the rejoin barrier"
        return out

    # -- phase C: the full world again, where the floor is judged -----------
    step_c = make_train_step(lenet_loss, tx_c, group, consensus=consensus)
    at_c = at(world, group)
    loss_c = float("nan")
    for i in range(steps_a + steps_b, steps_a + steps_b + steps_c):
        state_c, loss_c = step_c(state_c, at_c(i))
        monitor.update(i, guard_report(state_c))
        if reader is not None:
            reader.update(i, state_c)
    out.update(state_c=state_c, grc_c=grc_c, loss_c=float(loss_c))
    return out


def run(args, argv, group, device) -> int:
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.checkpoint import Checkpointer
    from grace_tpu_torch.core import Topology
    from grace_tpu_torch.resilience import (ChaosCompressor, ConsensusConfig,
                                            ElasticController,
                                            guarded_chain, plan_resize,
                                            validate_resharded)
    from grace_tpu_torch.train import init_train_state, make_train_step
    from grace_tpu_torch.utils.logging import GuardMonitor
    from grace_tpu_torch.utils.metrics import guard_report

    world = world_of(group)
    doomed = args.elastic_rank
    if args.hier:
        k = doomed // args.slice_size
        lost = tuple(range(k * args.slice_size, (k + 1) * args.slice_size))
        topo = Topology(slice_size=args.slice_size)
    else:
        lost = (doomed,)
        topo = Topology()
    plan = plan_resize(world, lost, topo)
    steps_a, steps_b, steps_c = phases(args)
    consensus = ConsensusConfig(audit_every=args.audit_every)

    def build(slice_size, region_size, g, drift_rank=None):
        """``(grace, guarded tx)`` on ``g``: rebuilding the transform is the
        resize's one topology-invalidation point."""
        p = {"compressor": "topk", "compress_ratio": 0.3,
             "memory": "residual", "communicator": "allgather",
             "escape": "fp16", "consensus": consensus,
             "telemetry": max(2 * args.telemetry_every, 16),
             "watch": {"window": args.watch_window,
                       "capacity": max(2 * args.telemetry_every
                                       // args.watch_window, 8)}}
        if args.hier:
            # A whole-slice loss keeps slice_size (the K→K−1 resize).
            p.update(communicator="hier", fusion="flat")
            if slice_size:
                p["slice_size"] = slice_size
        grc = grace_from_params(p, group=g)
        if drift_rank is not None:
            grc = dataclasses.replace(grc, compressor=ChaosCompressor(
                inner=grc.compressor, drift_scale=args.drift_scale,
                rank=drift_rank, seed=args.seed + 3, group=g))
        return grc, guarded_chain(grc, fallback_after=args.fallback_after,
                                  fallback_steps=args.fallback_steps)

    sink, reader, _ = telemetry(args, argv, group, "elastic", elastic=True,
                                elastic_rank=doomed, hier=args.hier)
    ckpt = Checkpointer(shared_dir(args.ckpt_dir, "grace_elastic_", group),
                        max_to_keep=2)
    controller = ElasticController(consensus=consensus, checkpointer=ckpt,
                                   sink=sink, anomaly_threshold=1,
                                   group=group)
    monitor = GuardMonitor(sink=sink)
    at = lenet_batches(args, device)

    # -- phase A: the full world, one rank drifting ------------------------
    _, tx_a = build(args.slice_size if args.hier else None, None, group,
                    drift_rank=doomed)
    model = lenet(args.seed, device)
    state = init_train_state(model, tx_a, torch.optim.SGD(
        model.parameters(), lr=args.lr), group)
    step = make_train_step(lenet_loss, tx_a, group, consensus=consensus)
    at_a = at(world, group)
    t0 = time.perf_counter()
    first_loss = drain_rank = drain_step = None
    seen = 0
    for i in range(steps_a):
        state, loss = step(state, at_a(i))
        if first_loss is None:
            first_loss = float(loss)
        monitor.update(i, guard_report(state))
        if reader is not None:
            reader.update(i, state)
            anomalies = reader.monitor.anomalies
            rank = controller.observe(i, anomalies[seen:])
            seen = len(anomalies)
            if rank is not None and drain_rank is None:
                drain_rank, drain_step = rank, i
                controller.drain(i, state, rank)
    if reader is not None and drain_rank is None:
        # The tail window may hold the first episode.
        reader.flush(state)
        rank = controller.observe(steps_a - 1,
                                  reader.monitor.anomalies[seen:])
        if rank is not None:
            drain_rank, drain_step = rank, steps_a - 1
            controller.drain(steps_a - 1, state, rank)
    if reader is not None and drain_rank is None:
        return fail(f"seeded drift on rank {doomed} produced no watch drain "
                    f"signal in {steps_a} steps — the early-warning channel "
                    "is broken")
    if reader is None:
        # No telemetry stream to carry the warning: drain unconditionally
        # so the lifecycle still runs.
        controller.drain(steps_a - 1, state, doomed)
        drain_rank, drain_step = doomed, steps_a - 1
    if drain_rank != doomed and not args.hier:
        return fail(f"drain signal named rank {drain_rank}, but rank "
                    f"{doomed} is the one drifting")
    if guard_report(state)["notfinite_count"] != 0:
        return fail("guard tripped during the drift phase — the elastic "
                    "faults are supposed to be guard-invisible")

    cyc = shrink_and_rejoin(
        args=args, group=group, device=device, controller=controller,
        ckpt=ckpt, reader=reader, monitor=monitor, state=state, plan=plan,
        build=build, topo_full=topo, at=at, resize_step=steps_a,
        steps_a=steps_a, steps_b=steps_b, steps_c=steps_c)
    if cyc["error"]:
        return fail(cyc["error"])
    loss_c, state_c, barrier = cyc["loss_c"], cyc["state_c"], cyc["barrier"]
    dt = time.perf_counter() - t0
    if reader is not None:
        reader.flush(state_c)
        reader.close()
    ckpt.close()

    gathered = [None] * world
    dist.all_gather_object(gathered, cyc["resize_down"]["footprint_matches"],
                           group=group)
    fp_down = all(v for v in gathered if v is not None)
    fp_up = validate_resharded(state_c, cyc["grc_c"], None, world)["matches"]
    floor_met = finite(loss_c) and loss_c < args.floor
    say(f"elastic: {steps_a}+{steps_b}+{steps_c} steps in {dt:.1f}s | W "
        f"{plan.old_world}->{plan.new_world}->{world} | loss "
        f"{first_loss:.4f} -> {loss_c:.4f} (floor {args.floor}) | drain "
        f"rank {drain_rank} @ step {drain_step}")

    if args.elastic_out and rank_of(group) == 0:
        doc = {
            "tool": "chaos_smoke",
            "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "argv": " ".join(argv),
            "world_cycle": [plan.old_world, plan.new_world, world],
            "hier": bool(args.hier),
            "slice_size": args.slice_size if args.hier else None,
            "drain": {"rank": drain_rank, "step": drain_step,
                      "episodes": controller.episodes.get(drain_rank, 0)},
            "resize_events": controller.events,
            "rejoin": {"rejoins": 1,
                       **{k: int(barrier[k]) for k in REJOIN_KEYS}},
            "floor": {"first_loss": first_loss, "final_loss": loss_c,
                      "floor": args.floor, "met": bool(floor_met)},
            "footprint": {str(plan.new_world): bool(fp_down),
                          str(world): bool(fp_up)},
        }
        write_evidence_doc(doc, args.elastic_out, ledger_id="elastic-drill",
                           metric="elastic_floor_met",
                           value=bool(floor_met), world=world,
                           device=device, ledger=args.ledger,
                           slice_size=(args.slice_size if args.hier
                                       else None),
                           label="elastic evidence")

    if not finite(loss_c):
        return fail("final loss non-finite after the rejoin")
    if not floor_met:
        return fail(f"final loss {loss_c:.4f} misses the convergence floor "
                    f"{args.floor}")
    if not (fp_down and fp_up):
        return fail("re-sharded state does not match the static footprint "
                    "model")
    say("OK")
    return 0
