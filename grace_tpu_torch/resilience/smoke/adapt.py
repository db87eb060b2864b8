"""``--adapt``: the adaptive ladder's drill, the counterpart of
``tools/chaos_smoke.py``'s ``_adapt_main``.

Phase A drifts one rank's encoder (finite: the guard must stay silent)
and the controller must tighten within one window, its ``adapt_tighten``
record ahead of any guard record; phase B removes the drift and the
controller must loosen back; phase C poisons the wire with NaNs, the guard
trips and the controller must register escalate-and-hold evidence. The
evidence lands in ``--adapt-out``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from grace_tpu_torch.resilience.smoke.common import (
    Tape, fail, finite, mlp, mlp_data, mlp_loss, mlp_params, rank_of,
    rows, say, world_batch, world_of, wrap_codec)
from grace_tpu_torch.resilience.smoke.evidence import (incident_sink,
                                                       write_evidence_doc)

DRIFT = 0.9
LADDER_DOC = ["fp16 dense escape (rung 0)", "qsgd quantum_num=127 (rung 1)",
              "qsgd quantum_num=15 (rung 2, steady state)"]


def grace_params(args) -> dict:
    """The ladder: the dense escape (rung 0), 8-bit QSGD (rung 1) and QSGD
    q=15 (rung 2, the steady state); the thresholds sit between the
    healthy error and the drifted rank's."""
    return {"compressor": "qsgd", "quantum_num": 15, "use_pallas": False,
            "memory": "none", "communicator": "allgather",
            "escape": "fp16",
            "telemetry": max(2 * args.telemetry_every, 16),
            "adapt": {"window": args.adapt_window,
                      "ladder": [{"quantum_num": 127}],
                      "tighten_error": 0.5, "tighten_peak": 0.6,
                      "loosen_error": 0.35, "quiet_windows": 2,
                      "hold_windows": 2}}


def phases(args):
    """The steps of phases A, B and C."""
    window = args.adapt_window
    steps_a = max(3 * window, args.steps // 3)
    steps_b = max(4 * window, args.steps // 3)
    steps_c = max(window + args.fallback_after + args.fallback_steps + 2,
                  args.steps - steps_a - steps_b)
    return steps_a, steps_b, steps_c


def run(args, argv, group, device) -> int:
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.resilience import (AdaptMonitor, ChaosCommunicator,
                                            ChaosCompressor, adapt_report,
                                            guarded_chain)
    from grace_tpu_torch.telemetry import (JSONLSink, MultiSink,
                                           TelemetryReader)
    from grace_tpu_torch.telemetry.timeline import Timeline
    from grace_tpu_torch.train import init_train_state, make_train_step
    from grace_tpu_torch.utils.logging import GuardMonitor, run_provenance
    from grace_tpu_torch.utils.metrics import guard_report

    world = world_of(group)
    window = args.adapt_window
    steps_a, steps_b, steps_c = phases(args)
    params = grace_params(args)

    def build(drift_rank=None, nan_prob=0.0):
        """The guarded chain of one phase; the drift wraps every rung."""
        grc = grace_from_params(params, group=group)
        if drift_rank is not None:
            grc = wrap_codec(grc, lambda c: ChaosCompressor(
                inner=c, drift_scale=DRIFT, rank=drift_rank,
                seed=args.seed + 3, group=group))
        if nan_prob:
            import dataclasses
            grc = dataclasses.replace(grc, communicator=ChaosCommunicator(
                inner=grc.communicator, nan_prob=nan_prob, rank=args.rank,
                seed=args.seed + 1))
        return guarded_chain(grc, fallback_after=args.fallback_after,
                             fallback_steps=args.fallback_steps)

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
        return fail("--adapt requires --telemetry-out: the acceptance "
                    "artifact IS the adapt_tighten/guard event ordering")
    prov = run_provenance(
        data="synthetic", tool="chaos_smoke", argv=" ".join(argv),
        steps=args.steps, adapt=True, adapt_window=window,
        adapt_rank=args.adapt_rank)
    tape = Tape()
    sink, _ = incident_sink(JSONLSink(args.telemetry_out, provenance=prov),
                            args, prov, "adapt")
    sink = MultiSink(sink, tape)
    reader = TelemetryReader(sink, every=args.telemetry_every, group=group)
    adapt_mon = AdaptMonitor(sink=sink)
    monitor = GuardMonitor(sink=sink)

    model = mlp(init, device)
    opt = torch.optim.SGD(model.parameters(), lr=args.lr)
    t0 = time.perf_counter()

    def run_phase(state, tx, lo, hi):
        step = make_train_step(mlp_loss, tx, group)
        loss = float("nan")
        for i in range(lo, hi):
            state, loss = step(state, at(i))
            monitor.update(i, guard_report(state))
            adapt_mon.observe(reader.update(i, state))
        adapt_mon.observe(reader.flush(state))        # drain the tail
        return state, float(loss)

    # -- phase A: one rank's encoder drifts: tighten, the guard silent --
    tx_a = build(drift_rank=args.adapt_rank)
    state = init_train_state(model, tx_a, opt, group)
    state, _ = run_phase(state, tx_a, 0, steps_a)
    guard_a = guard_report(state)
    tightens = [e for e in adapt_mon.events if e["event"] == "adapt_tighten"]
    first_tighten = min((e["step"] for e in tightens), default=None)
    rep_a = adapt_report(state)
    say(f"adapt phase A (drift rank {args.adapt_rank}): {steps_a} steps | "
        f"rung {rep_a['rung']} | tightens {rep_a['tightens']} (first event "
        f"step {first_tighten}) | guard skips {guard_a['notfinite_count']}")
    if guard_a["notfinite_count"] != 0:
        return fail("guard tripped during the drift phase — the fault is "
                    "finite and guard-invisible; the smoke itself is broken")
    if not tightens:
        return fail("seeded drift produced no adapt_tighten event — the "
                    "controller is not reacting to the error spike")
    if first_tighten > 2 * window:
        return fail(f"first tighten at step {first_tighten} — later than "
                    f"one window ({window}) plus the decision latency")

    # -- phase B: the drift off: the controller must loosen back --------
    state, _ = run_phase(state, build(), steps_a, steps_a + steps_b)
    loosens = [e for e in adapt_mon.events if e["event"] == "adapt_loosen"]
    rep_b = adapt_report(state)
    say(f"adapt phase B (quiet): {steps_b} steps | rung {rep_b['rung']} | "
        f"loosens {rep_b['loosens']}")
    if not loosens:
        return fail("quiet phase produced no adapt_loosen event — the "
                    "controller never recovers from degradation")

    # -- phase C: NaN injection: the guard trips, the controller escalates
    end = steps_a + steps_b + steps_c
    state, total = run_phase(state, build(nan_prob=1.0), steps_a + steps_b,
                             end)
    reader.close()
    dt = time.perf_counter() - t0
    guard_c = guard_report(state)
    rep_c = adapt_report(state)
    say(f"adapt phase C (NaN): {steps_c} steps | final loss {total:.4f} | "
        f"guard skips {guard_c['notfinite_count']} | escalations "
        f"{rep_c['escalations']} | hold {rep_c['hold']} | {dt:.1f}s total")

    # The ordering is judged from the record stream, not loop bookkeeping.
    tl = Timeline.from_records(tape.records)
    first_adapt = next((e for e in tl.kinds("adapt")
                        if e.step is not None), None)
    first_guard = next((e for e in tl.kinds("guard")
                        if e.step is not None), None)
    ordering_ok = (first_adapt is not None and first_guard is not None
                   and first_adapt.step < first_guard.step)
    say(f"adapt ordering: first adapt event step "
        f"{first_adapt.step if first_adapt else None} < first guard event "
        f"step {first_guard.step if first_guard else None} -> "
        f"{'OK' if ordering_ok else 'VIOLATED'}")

    if args.adapt_out and rank_of(group) == 0:
        doc = {
            "tool": "chaos_smoke",
            "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "argv": " ".join(argv),
            "world": world,
            "window": window,
            "ladder": list(LADDER_DOC),
            "phases": {"drift": [0, steps_a],
                       "quiet": [steps_a, steps_a + steps_b],
                       "nan": [steps_a + steps_b, end]},
            "tighten": {"count": int(rep_c["tightens"]),
                        "first_step": first_tighten,
                        "within_one_window": bool(
                            first_tighten <= 2 * window)},
            "loosen": {"count": int(rep_c["loosens"]),
                       "first_step": min((e["step"] for e in loosens),
                                         default=None)},
            "escalations": int(rep_c["escalations"]),
            "final_rung": int(rep_c["rung"]),
            "first_adapt_step": first_adapt.step if first_adapt else None,
            "first_guard_step": first_guard.step if first_guard else None,
            "ordering_ok": bool(ordering_ok),
            "guard_skips": int(guard_c["notfinite_count"]),
            "final_loss": float(total),
        }
        write_evidence_doc(doc, args.adapt_out, ledger_id="adapt-drill",
                           metric="adapt_ordering_ok",
                           value=bool(ordering_ok), world=world,
                           device=device, ledger=args.ledger,
                           label="adapt evidence")

    if not finite(total):
        return fail("final loss non-finite — the guard+ladder stack did "
                    "not contain the NaN phase")
    if guard_c["notfinite_count"] == 0:
        return fail("guard never tripped in the NaN phase — injection is "
                    "not reaching the pipeline")
    if rep_c["escalations"] == 0:
        return fail("the controller registered no escalate-and-hold "
                    "evidence despite the guard's fallback windows")
    if not ordering_ok:
        return fail("the first adapt event does not precede the first "
                    "guard event — tighten-before-guard is the scenario's "
                    "claim")
    say("OK")
    return 0
