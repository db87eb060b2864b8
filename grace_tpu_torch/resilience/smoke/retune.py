"""``--retune``: online re-tuning as a transaction, the counterpart of
``tools/chaos_smoke.py``'s ``_retune_main``.

The run warms up on the 4-bit homomorphic codec (homoqsgd q=7) while the
:class:`RetuneController` learns its healthy compression-error baseline;
a fleet-wide finite drift (every rank: the window mean moves, the guard
stays silent) gives a ``retune_drift`` verdict. The controller promotes
PowerSGD rank 4 with a rank-1 adapt ladder (PREPARE: the audit in a child,
the state migrated, the footprint checked, the incumbent checkpointed;
COMMIT behind the consensus barrier), the probation clears, a second
promotion migrates back, and a sabotaged third promotion (its codec
wrapped in ``ChaosCompressor(nan_prob=1.0)``) trips the guard during its
probation and is demoted bit for bit. ``--retune-funnel`` re-runs the
tuner's bounded funnel after the verdict. The evidence lands in
``--retune-out``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from grace_tpu_torch.resilience.smoke.common import (
    Tape, fail, finite, mlp, mlp_data, mlp_loss, mlp_params, rank_of, rows,
    say, shared_dir, world_batch, world_of, wrap_codec)
from grace_tpu_torch.resilience.smoke.evidence import (incident_sink,
                                                       write_evidence_doc)

ORDER = ("retune_drift", "retune_prepare", "retune_promote",
         "retune_probation_clear")


def chaos_build(group, chaos: dict, *, drift_scale: float, rank: int,
                seed: int, guard_kw: dict, tx_seed: int = 0):
    """The drill's chain factory ``build(grace_params) -> (grace, tx)``:
    the configuration on ``group`` under the guard, its codec (and every
    ladder rung) wrapped while ``chaos["drift"]`` (a finite drift on every
    rank, seeded ``seed + 3``) or ``chaos["nan"]`` (NaNs on ``rank``,
    seeded ``seed + 5``) is set. The flags are toggled outside the
    controller, so one factory serves every transition, and a demotion's
    rebuild of the incumbent sees clean flags."""
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.resilience import ChaosCompressor, guarded_chain

    def build(p):
        grc = grace_from_params(p, group=group)
        if chaos.get("drift"):
            grc = wrap_codec(grc, lambda c: ChaosCompressor(
                inner=c, drift_scale=drift_scale, rank=None,
                seed=seed + 3, group=group))
        if chaos.get("nan"):
            grc = wrap_codec(grc, lambda c: ChaosCompressor(
                inner=c, nan_prob=1.0, rank=rank, seed=seed + 5,
                group=group))
        return grc, guarded_chain(grc, seed=tx_seed, **guard_kw)

    return build


def run(args, argv, group, device) -> int:
    from grace_tpu_torch.checkpoint import Checkpointer
    from grace_tpu_torch.resilience import (ConsensusConfig,
                                            RetuneController,
                                            replica_variants)
    from grace_tpu_torch.telemetry import (JSONLSink, MultiSink,
                                           TelemetryReader)
    from grace_tpu_torch.telemetry.timeline import Timeline
    from grace_tpu_torch.train import init_train_state, make_train_step
    from grace_tpu_torch.utils.logging import GuardMonitor, run_provenance
    from grace_tpu_torch.utils.metrics import guard_report

    world = world_of(group)
    window = args.retune_window
    probation = args.retune_probation
    # A flush cadence no longer than the drift window, or the controller
    # sees rows (and can fire) only at flush boundaries.
    tev = max(1, min(args.telemetry_every, window))
    telem = max(2 * tev, 16)
    consensus = ConsensusConfig(audit_every=args.audit_every)
    old_params = {"compressor": "homoqsgd", "quantum_num": 7,
                  "memory": "residual", "communicator": "allreduce",
                  "fusion": "flat", "escape": "fp16",
                  "telemetry": telem, "consensus": consensus}
    new_params = {"compressor": "powersgd", "compress_rank": 4,
                  "memory": "powersgd", "communicator": "allreduce",
                  "escape": "fp16", "telemetry": telem,
                  "consensus": consensus,
                  "adapt": {"window": window,
                            "ladder": [{"compress_rank": 1}]}}
    chaos = {"drift": False, "nan": False}
    build = chaos_build(group, chaos, drift_scale=args.drift_scale,
                        rank=args.rank, seed=args.seed,
                        guard_kw={"fallback_after": args.fallback_after,
                                  "fallback_steps": args.fallback_steps})

    rng = np.random.default_rng(args.seed)
    init = mlp_params(rng)
    batch = world_batch(args.batch, world)
    images, labels = mlp_data(rng, batch)

    def at(i):
        lo = (i * batch) % (len(images) - batch + 1)
        part = rows(batch, rank_of(group), world, lo)
        return (torch.from_numpy(images[part]).to(device),
                torch.from_numpy(labels[part].astype(np.int64)).to(device))

    if not args.telemetry_out:
        return fail("--retune requires --telemetry-out: the acceptance "
                    "artifact IS the retune event ordering")
    prov = run_provenance(data="synthetic", tool="chaos_smoke",
                          argv=" ".join(argv), steps=args.steps,
                          retune=True, retune_window=window,
                          retune_probation=probation)
    tape = Tape()
    sink, _ = incident_sink(JSONLSink(args.telemetry_out, provenance=prov),
                            args, prov, "retune")
    sink = MultiSink(sink, tape)
    reader = TelemetryReader(sink, every=tev, group=group)
    monitor = GuardMonitor(sink=sink)
    ckpt = Checkpointer(shared_dir(args.ckpt_dir, "grace-retune-", group),
                        max_to_keep=2)
    ctl = RetuneController(
        build=build, params=old_params, consensus=consensus,
        checkpointer=ckpt, sink=sink, window=window, drift_factor=1.4,
        drift_windows=2, probation_steps=probation,
        leg_timeout_s=args.drain_timeout or None, leg_retries=1,
        # A one-rank world audits at two: its replication pass tells a
        # replicated write from a rank-varying one across a second rank.
        audit_world=max(world, 2), group=group)

    def step_of(tx, p):
        return make_train_step(mlp_loss, tx, group,
                               consensus=p["consensus"])

    t0 = time.perf_counter()
    model = mlp(init, device)
    _, tx = build(old_params)
    state = init_train_state(model, tx, torch.optim.SGD(
        model.parameters(), lr=args.lr), group)

    def run_steps(state, step_fn, lo, hi, observe=False):
        """Advance ``[lo, hi)``: ``(state, loss, drift step, probation
        trigger, last step)``. Each step feeds the guard monitor, the
        telemetry rows into the drift watch (``observe``) and, during a
        probation, this step's records into :meth:`RetuneController.
        watch`."""
        loss, drift_step, trigger = float("nan"), None, None
        for i in range(lo, hi):
            state, loss = step_fn(state, at(i))
            n0 = len(tape.records)
            monitor.update(i, guard_report(state))
            rows_ = reader.update(i, state)
            if observe:
                for row in rows_:
                    if ctl.observe(row["step"],
                                   row.get("compression_error")):
                        if drift_step is None:
                            drift_step = int(row["step"])
                if drift_step is not None:
                    return state, float(loss), drift_step, None, i
            if ctl.phase == "probation":
                trigger = ctl.watch(i, tape.records[n0:])
                if trigger:
                    return state, float(loss), drift_step, trigger, i
        return state, float(loss), drift_step, None, hi - 1

    # -- the healthy drill: baseline → fleet drift → retune_drift -----------
    warmup = 3 * window + 2
    state, loss, _, _, _ = run_steps(state, step_of(tx, old_params), 0,
                                     warmup, observe=True)
    chaos["drift"] = True
    _, tx_d = build(old_params)
    chaos["drift"] = False
    drift_cap = warmup + 8 * window
    state, loss, drift_step, _, last = run_steps(
        state, step_of(tx_d, old_params), warmup, drift_cap, observe=True)
    guard_rep = guard_report(state)
    say(f"retune drift: fleet drift_scale {args.drift_scale} from step "
        f"{warmup} | retune_drift at step {drift_step} | guard skips "
        f"{guard_rep['notfinite_count']}")
    if drift_step is None:
        return fail("sustained fleet-wide drift never produced a "
                    "retune_drift verdict — the controller is not reading "
                    "the telemetry it was built for")
    if guard_rep["notfinite_count"] != 0:
        return fail("guard tripped during the drift phase — the fault is "
                    "finite and guard-invisible; the smoke itself is broken")

    # -- the optional bounded funnel against the live group -----------------
    funnel_doc = None
    if args.retune_funnel:
        funnel_doc = ctl.propose(
            last + 1, str(world), device=device, model="toy",
            shortlist_n=2, timed_steps=2, repeats=1, seed=args.seed,
            audit_world=world)
        say(f"retune funnel: winner "
            f"{funnel_doc['winner'] if funnel_doc else None}")

    def promote(i, state, cand, label):
        """One PREPARE + COMMIT transaction; ``(None, reason)`` on an
        abort."""
        staged = ctl.prepare(i, state, cand)
        if staged is None:
            return None, (f"PREPARE aborted for {label}: "
                          f"{ctl.events[-1]}")
        out = ctl.commit(i)
        if out is None:
            return None, (f"COMMIT timed out for {label} — incumbent "
                          f"retained: {ctl.events[-1]}")
        state, (_, tx), ev = out
        mig = staged.migration
        say(f"retune promote ({label}) at step {i}: mem {mig['mem']} comp "
            f"{mig['comp']} | footprint {staged.footprint_matches} | "
            f"checkpointed {staged.checkpointed} | probation until "
            f"{ev['probation_until']}")
        return (state, tx, ev, mig), None

    # -- promotion 1: homoqsgd4 → the PowerSGD rank ladder --------------------
    i0 = last + 1
    out, why = promote(i0, state, new_params, "homoqsgd4 -> powersgd ladder")
    if out is None:
        return fail(why)
    state, tx2, ev_fwd, mig_fwd = out
    variants_fwd = replica_variants(state, group)
    state, loss, _, trig, _ = run_steps(state, step_of(tx2, new_params), i0,
                                        i0 + probation + 1)
    if trig is not None:
        return fail(f"healthy probation tripped ({trig}) after the forward "
                    "promotion")
    if ctl.phase != "idle":
        return fail("probation never cleared after the forward promotion")

    # -- promotion 2: back to homoqsgd4 (the reverse migration) ----------------
    i0 += probation + 1
    out, why = promote(i0, state, old_params, "powersgd ladder -> homoqsgd4")
    if out is None:
        return fail(why)
    state, tx3, ev_back, mig_back = out
    state, loss, _, trig, _ = run_steps(state, step_of(tx3, old_params), i0,
                                        i0 + probation + 1)
    if trig is not None or ctl.phase != "idle":
        return fail(f"back-promotion probation did not clear quietly "
                    f"(trigger={trig}, phase={ctl.phase})")
    healthy_guard = [r for r in tape.records
                     if str(r.get("event", "")).startswith("guard")]
    say(f"retune healthy drill done: loss {loss:.4f} | replica variants "
        f"after forward commit {variants_fwd} | guard events "
        f"{len(healthy_guard)}")
    if healthy_guard:
        return fail("the guard fired during the healthy drill — promotion "
                    "must be guard-invisible")
    if variants_fwd != 1:
        return fail(f"{variants_fwd} replica variants after the "
                    "consensus-gated cutover")

    # -- sabotage: the promoted config is poisoned → demote ------------------
    i0 += probation + 1
    chaos["nan"] = True
    try:
        out, why = promote(i0, state, new_params, "sabotaged powersgd ladder")
    finally:
        chaos["nan"] = False
    if out is None:
        return fail(why)
    state, tx_sab, ev_sab, _ = out
    sab_state, loss, _, trig, trig_step = run_steps(
        state, step_of(tx_sab, new_params), i0, i0 + probation + 1)
    if trig is None:
        return fail("the poisoned promotion survived its probation window "
                    "— the NaN injection never reached the guard")
    within = trig_step < ev_sab["probation_until"]
    state, (_, tx4), ev_dem = ctl.demote(trig_step, sab_state, trigger=trig)
    state, loss, _, _, _ = run_steps(state, step_of(tx4, old_params),
                                     trig_step, trig_step + 4)
    reader.flush(state)
    reader.close()
    ckpt.close()
    dt = time.perf_counter() - t0
    say(f"retune sabotage: trigger {trig} at step {trig_step} (probation "
        f"until {ev_sab['probation_until']}) | demote "
        f"restored={ev_dem['restored']} bit_exact={ev_dem['bit_exact']} | "
        f"post-demote loss {loss:.4f} | {dt:.1f}s total")

    # The order is judged from the record stream, not loop bookkeeping.
    firsts: dict = {}
    for e in Timeline.from_records(tape.records).kinds("retune"):
        name = str(e.record.get("event"))
        if name not in firsts and e.step is not None:
            firsts[name] = e.step
    ordering_ok = (all(n in firsts for n in ORDER)
                   and all(firsts[a] <= firsts[b]
                           for a, b in zip(ORDER, ORDER[1:]))
                   and "retune_demote" in firsts)
    say("retune ordering: " + " <= ".join(
        f"{n.split('retune_')[1]}@{firsts.get(n)}" for n in ORDER)
        + f", demote@{firsts.get('retune_demote')} -> "
        + ("OK" if ordering_ok else "VIOLATED"))

    if args.retune_out and rank_of(group) == 0:
        measured = (funnel_doc or {}).get("measured") or {}
        doc = {
            "tool": "chaos_smoke",
            "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "argv": " ".join(argv),
            "world": world,
            "window": window,
            "probation_steps": probation,
            "incumbent": "homoqsgd quantum_num=7 (4-bit shared-scale)",
            "candidate": "powersgd rank 4 + rank-1 adapt ladder",
            "drift": {"scale": args.drift_scale, "from_step": warmup,
                      "verdict_step": drift_step},
            "funnel": (None if funnel_doc is None else {
                "winner": funnel_doc.get("winner"),
                "measured": [
                    {"candidate": r["candidate"],
                     "measured_step_ms": r["measured_step_ms"],
                     "projected_step_ms": r["projected_step_ms"]}
                    for r in measured.get("rows", [])],
                "skipped": measured.get("skipped", [])}),
            "forward_promotion": {
                "step": ev_fwd["step"], "migration": mig_fwd,
                "replica_variants": variants_fwd,
                "probation_until": ev_fwd["probation_until"]},
            "back_promotion": {
                "step": ev_back["step"], "migration": mig_back,
                "probation_until": ev_back["probation_until"]},
            "sabotage": {
                "promote_step": ev_sab["step"], "trigger": trig,
                "trigger_step": trig_step,
                "probation_until": ev_sab["probation_until"],
                "within_probation": bool(within),
                "restored": bool(ev_dem["restored"]),
                "bit_exact": bool(ev_dem["bit_exact"])},
            "guard_events_during_healthy_drill": len(healthy_guard),
            "ordering_ok": bool(ordering_ok),
            "first_steps": firsts,
            "final_loss": float(loss),
        }
        write_evidence_doc(doc, args.retune_out, ledger_id="retune-drill",
                           metric="retune_demote_bit_exact",
                           value=bool(ev_dem["bit_exact"]), world=world,
                           device=device, ledger=args.ledger,
                           label="retune evidence")

    if not finite(loss):
        return fail("final loss non-finite after the demotion — the "
                    "rollback did not restore a trainable state")
    if not within:
        return fail("the demotion landed outside the probation window")
    if not (ev_dem["restored"] and ev_dem["bit_exact"]):
        return fail("demotion did not restore the last-known-good "
                    "checkpoint bit-exactly")
    if not ordering_ok:
        return fail("the record stream's retune event order violates the "
                    "transaction sequence")
    say("OK")
    return 0
