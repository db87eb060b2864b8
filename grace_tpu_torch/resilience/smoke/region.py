"""``--region``: the cross-region failure lifecycle, the counterpart of
``tools/chaos_smoke.py``'s ``_region_main``.

The world is laid out as regions of ``--region-size`` ranks, each two
slices wide (``Topology(slice_size=rz/2, region_size=rz)``, the
three-level hierarchical exchange). One rank of each slice of the last
region drifts (guard-blind); once a quorum of the region's ranks carries
skew episodes the :class:`ElasticController` widens the drain to the whole
region, and handles it as one drain → resize → rejoin: the region leaves
(an R→R−1 resize that collapses to two tiers when one region remains),
the survivors train at W−rz, and the region rejoins behind one barrier
repair. The evidence lands in ``--region-out``.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from grace_tpu_torch.resilience.smoke.common import (fail, finite, lenet,
                                                     lenet_loss, rank_of,
                                                     say, shared_dir,
                                                     world_of)
from grace_tpu_torch.resilience.smoke.elastic import (REJOIN_KEYS,
                                                      lenet_batches, phases,
                                                      shrink_and_rejoin,
                                                      telemetry)
from grace_tpu_torch.resilience.smoke.evidence import write_evidence_doc


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
    rz = args.region_size
    # Slices half a region wide: intra-slice hops, same-region cross-slice
    # gathers and cross-region gathers in every run.
    s = max(1, rz // 2)
    topo3 = Topology(slice_size=s, region_size=rz)
    doomed_region = world // rz - 1              # the last region leaves
    lost = tuple(range(doomed_region * rz, (doomed_region + 1) * rz))
    # One drifting rank per slice of the doomed region: enough for the
    # quorum, few enough that the fleet median stays healthy.
    drift_ranks = tuple(doomed_region * rz + k * s for k in range(rz // s))
    plan = plan_resize(world, lost, topo3)
    steps_a, steps_b, steps_c = phases(args)
    consensus = ConsensusConfig(audit_every=args.audit_every)

    def build(slice_size, region_size, g, drift=()):
        p = {"compressor": "topk", "compress_ratio": 0.3,
             "memory": "residual", "communicator": "hier",
             "fusion": "flat", "escape": "fp16", "consensus": consensus,
             "telemetry": max(2 * args.telemetry_every, 16),
             "watch": {"window": args.watch_window,
                       "capacity": max(2 * args.telemetry_every
                                       // args.watch_window, 8)}}
        if slice_size:
            p["slice_size"] = slice_size
        if region_size:
            p["region_size"] = region_size
        grc = grace_from_params(p, group=g)
        for dr in drift:
            grc = dataclasses.replace(grc, compressor=ChaosCompressor(
                inner=grc.compressor, drift_scale=args.drift_scale,
                rank=dr, seed=args.seed + 3 + dr, group=g))
        return grc, guarded_chain(grc, fallback_after=args.fallback_after,
                                  fallback_steps=args.fallback_steps)

    sink, reader, _ = telemetry(args, argv, group, "region", region=True,
                                region_size=rz, slice_size=s)
    ckpt = Checkpointer(shared_dir(args.ckpt_dir, "grace_region_", group),
                        max_to_keep=2)
    controller = ElasticController(
        consensus=consensus, checkpointer=ckpt, sink=sink,
        anomaly_threshold=1, topology=topo3, region_quorum=0.5,
        drain_timeout_s=args.drain_timeout or None, drain_retries=1,
        group=group)
    monitor = GuardMonitor(sink=sink)
    at = lenet_batches(args, device)

    # -- phase A: one rank per slice of the last region drifting ----------
    _, tx_a = build(s, rz, group, drift=drift_ranks)
    model = lenet(args.seed, device)
    state = init_train_state(model, tx_a, torch.optim.SGD(
        model.parameters(), lr=args.lr), group)
    step = make_train_step(lenet_loss, tx_a, group, consensus=consensus)
    at_a = at(world, group)
    t0 = time.perf_counter()
    first_loss = drain_rank = drain_step = None
    drain_scope: tuple = ()
    seen = 0

    def try_drain(i, state) -> bool:
        """Widen each flagged rank to its region scope; drain only when
        the episode is region-wide (the one-transition contract)."""
        nonlocal drain_rank, drain_step, drain_scope
        for r in sorted(controller.episodes):
            scope = controller.region_scope(r)
            if len(scope) > 1:
                controller.drain(i, state, r, scope=scope)
                drain_rank, drain_step, drain_scope = r, i, scope
                return True
        return False

    for i in range(steps_a):
        state, loss = step(state, at_a(i))
        if first_loss is None:
            first_loss = float(loss)
        monitor.update(i, guard_report(state))
        if reader is not None and drain_rank is None:
            reader.update(i, state)
            anomalies = reader.monitor.anomalies
            # One record at a time: observe() returns at a threshold
            # crossing and would drop the rest of the batch.
            for a in anomalies[seen:]:
                controller.observe(i, [a])
            seen = len(anomalies)
            if try_drain(i, state):
                break
    if reader is not None and drain_rank is None:
        reader.flush(state)
        for a in reader.monitor.anomalies[seen:]:
            controller.observe(steps_a - 1, [a])
        try_drain(steps_a - 1, state)
    if reader is not None and drain_rank is None:
        return fail(f"seeded drift on ranks {list(drift_ranks)} produced no "
                    f"region-wide drain signal in {steps_a} steps "
                    f"(episodes: {controller.episodes}) — the early-warning "
                    "channel is broken")
    if reader is None:
        controller.episodes.update({r: 1 for r in drift_ranks})
        drain_scope = controller.region_scope(drift_ranks[0])
        controller.drain(steps_a - 1, state, drift_ranks[0],
                         scope=drain_scope)
        drain_rank, drain_step = drift_ranks[0], steps_a - 1
    if tuple(sorted(drain_scope)) != lost:
        return fail(f"drain scope {sorted(drain_scope)} is not the doomed "
                    f"region {list(lost)}")
    drain_events = [e for e in controller.events
                    if e["event"] == "elastic_drain"]
    if len(drain_events) != 1:
        return fail(f"{len(drain_events)} drain transitions for ONE "
                    "region-wide episode")
    guard_a = guard_report(state)
    if guard_a["notfinite_count"] != 0:
        return fail("guard tripped during the drift phase — the region "
                    "faults are supposed to be guard-invisible")
    if not plan.whole_regions or plan.topology.region_size is not None:
        return fail(f"plan {plan} did not recognize the whole-region loss / "
                    "single-region collapse")

    cyc = shrink_and_rejoin(
        args=args, group=group, device=device, controller=controller,
        ckpt=ckpt, reader=reader, monitor=monitor, state=state, plan=plan,
        build=build, topo_full=topo3, at=at, resize_step=drain_step,
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
    timeouts = sum(e.get("drain_timeouts", 0) for e in drain_events)
    say(f"region: {steps_a}+{steps_b}+{steps_c} steps in {dt:.1f}s | W "
        f"{plan.old_world}->{plan.new_world}->{world} | loss "
        f"{first_loss:.4f} -> {loss_c:.4f} (floor {args.floor}) | drain "
        f"scope {list(drain_scope)} @ step {drain_step}")

    if args.region_out and rank_of(group) == 0:
        doc = {
            "tool": "chaos_smoke",
            "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "argv": " ".join(argv),
            "world_cycle": [plan.old_world, plan.new_world, world],
            "slice_size": s,
            "region_size": rz,
            "regions": world // rz,
            "drift_ranks": list(drift_ranks),
            "drain": {"rank": drain_rank, "step": drain_step,
                      "scope": list(drain_scope),
                      "region_wide": len(drain_scope) == rz,
                      "transitions": len(drain_events),
                      "drain_timeouts": timeouts,
                      "episodes": dict(sorted(
                          (str(k), v)
                          for k, v in controller.episodes.items()))},
            "resize_events": controller.events,
            "rejoin": {"rejoins": 1, "rejoined_ranks": len(lost),
                       **{k: int(barrier[k]) for k in REJOIN_KEYS}},
            "floor": {"first_loss": first_loss, "final_loss": loss_c,
                      "floor": args.floor, "met": bool(floor_met)},
            "footprint": {str(plan.new_world): bool(fp_down),
                          str(world): bool(fp_up)},
            "guard_silent": guard_a["notfinite_count"] == 0,
        }
        write_evidence_doc(doc, args.region_out, ledger_id="region-drill",
                           metric="region_floor_met",
                           value=bool(floor_met), world=world,
                           device=device, ledger=args.ledger, slice_size=s,
                           region_size=rz, label="region evidence")

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
