"""``--fsdp``: the chaos matrix over a dp×fsdp mesh, the counterpart of
``tools/chaos_smoke.py``'s ``_fsdp_main``.

A tensor-parallel MLP with every parameter sharded over fsdp (the biases
gathered, each weight shard contracted against its slice of the input,
the partials summed over fsdp), the routed rscatter exchange (the weights
Top-K per shard, the biases dense fp16), NaN injection on one dp rank
(the guard's rollback must stay atomic across the per-shard exchanges and
its verdict span the mesh) and single-rank parameter SDC (the audit
fingerprints replicas per fsdp shard over the dp group and must repair
within one window). Exit 0 needs a finite loss, a guard trip, every SDC
repaired, replicas bit-identical per shard and telemetry rows carrying the
two-link wire split.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from grace_tpu_torch.resilience.smoke.common import (CLASSES, FEAT, HID,
                                                     Tape, fail, finite,
                                                     mlp_params, say,
                                                     world_of)
from grace_tpu_torch.resilience.smoke.evidence import incident_sink

SPECS = {"w1": 0, "b1": 0, "w2": 0, "b2": 0}     # every param on fsdp


def loss_for(mesh):
    """The FSDP forward: gather the sharded biases, contract each weight
    shard against this shard's slice of the input, sum the partials over
    fsdp (the gather's backward hands each owner its shard's gradient)."""
    from grace_tpu_torch.parallel import all_gather, psum
    fsdp = mesh.shape[1]
    feat_sh, hid_sh = FEAT // fsdp, HID // fsdp

    def loss_fn(model, batch):
        x, y = batch
        f, grp = mesh.fsdp_index, mesh.fsdp_group
        b1 = all_gather(model["b1"], grp)
        b2 = all_gather(model["b2"], grp)
        xs = x[:, f * feat_sh:(f + 1) * feat_sh]
        h = torch.tanh(psum(xs @ model["w1"], grp) + b1)
        hs = h[:, f * hid_sh:(f + 1) * hid_sh]
        logits = psum(hs @ model["w2"], grp) + b2
        return torch.nn.functional.cross_entropy(logits, y)

    return loss_fn


def run(args, argv, group, device) -> int:
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.parallel import make_mesh
    from grace_tpu_torch.resilience import (ChaosCommunicator, ChaosParams,
                                            ConsensusConfig, audit_report,
                                            guarded_chain, replica_variants)
    from grace_tpu_torch.telemetry import (JSONLSink, MultiSink,
                                           TelemetryReader)
    from grace_tpu_torch.train import (init_train_state, make_train_step,
                                       shard_params)
    from grace_tpu_torch.utils.logging import (ConsensusMonitor,
                                               GuardMonitor, run_provenance)
    from grace_tpu_torch.utils.metrics import guard_report

    import dataclasses

    world = world_of(group)
    fsdp = max(1, args.fsdp_size)
    dp = world // fsdp
    mesh = make_mesh((dp, fsdp), ("data", "fsdp"), group=group)

    rng = np.random.default_rng(args.seed)
    init = mlp_params(rng)
    consensus = ConsensusConfig(audit_every=args.audit_every,
                                escalate_window=4 * args.audit_every,
                                escalate_steps=args.fallback_steps)
    sdc_steps = (tuple(int(s) for s in args.sdc_steps.split(","))
                 if args.sdc_steps
                 else (args.steps // 3, 2 * args.steps // 3))
    sdc = ChaosParams(rank=args.sdc_rank, at_steps=sdc_steps,
                      seed=args.seed + 2)
    params = {
        "compressor": "topk", "compress_ratio": 0.3, "memory": "residual",
        "communicator": "rscatter", "fsdp_axis": "fsdp",
        # a slice boundary inside the dp axis: the rscatter rows price a
        # DCN leg, the two-link split of the artifact
        "slice_size": max(1, dp // 2),
        "route": [("b*", {"compressor": "fp16", "memory": "none",
                          "communicator": "allreduce"})],
        "escape": "fp16", "consensus": consensus,
        "telemetry": max(2 * args.telemetry_every, 16)}
    grc = grace_from_params(params, group=mesh)
    grc = dataclasses.replace(grc, communicator=ChaosCommunicator(
        inner=grc.communicator, nan_prob=args.nan_prob, rank=args.rank,
        seed=args.seed + 1))
    tx = guarded_chain(grc, fallback_after=args.fallback_after,
                       fallback_steps=args.fallback_steps)
    local = shard_params({n: torch.from_numpy(a) for n, a in init.items()},
                         SPECS, mesh)
    model = torch.nn.ParameterDict(
        {n: torch.nn.Parameter(t.clone().to(device))
         for n, t in local.items()})
    state = init_train_state(model, tx, torch.optim.SGD(
        model.parameters(), lr=args.lr), mesh=mesh, param_specs=SPECS)
    step = make_train_step(loss_for(mesh), tx, mesh=mesh, param_specs=SPECS,
                           consensus=consensus)

    tape = Tape()
    sink = reader = None
    if args.telemetry_out:
        prov = run_provenance(data="synthetic", tool="chaos_smoke",
                              argv=" ".join(argv), nan_prob=args.nan_prob,
                              steps=args.steps, fsdp=fsdp, dp=dp)
        sink, _ = incident_sink(JSONLSink(args.telemetry_out,
                                          provenance=prov), args, prov,
                                "fsdp")
        sink = MultiSink(sink, tape)
        reader = TelemetryReader(sink, every=args.telemetry_every,
                                 group=group)
    monitor = GuardMonitor(sink=sink)
    consensus_mon = ConsensusMonitor(sink=sink)

    batch_n = max(args.batch, dp) // dp * dp
    images = rng.normal(size=(4 * batch_n, FEAT)).astype(np.float32)
    labels = rng.integers(0, CLASSES, size=(4 * batch_n,)).astype(np.int32)

    loss = float("nan")
    t0 = time.perf_counter()
    for i in range(args.steps):
        state = sdc(state, i)
        lo = (i * batch_n) % len(images)
        b = mesh.dp_rows((
            torch.from_numpy(images[lo:lo + batch_n]).to(device),
            torch.from_numpy(labels[lo:lo + batch_n].astype(np.int64)).to(
                device)))
        state, loss = step(state, b)
        monitor.update(i, guard_report(state))
        consensus_mon.update(i, audit_report(state))
        if reader is not None:
            reader.update(i, state)
    loss = float(loss)
    dt = time.perf_counter() - t0
    if reader is not None:
        reader.flush(state)
        reader.close()

    rep = guard_report(state)
    # The audit state is replicated within each dp group (its
    # jurisdiction): a repair in one fsdp group never bumps another's
    # counter, so sum the groups' counts.
    mine = (mesh.fsdp_index, audit_report(state)["repairs"],
            replica_variants(state, mesh.dp_group))
    every = [None] * world
    dist.all_gather_object(every, mine, group=group)
    group_repairs = [max(r for f, r, _ in every if f == k)
                     for k in range(fsdp)]
    repairs = sum(group_repairs)
    variants = max(v for _, _, v in every)
    say(f"fsdp: {args.steps} steps in {dt:.1f}s on dp{dp}×fsdp{fsdp} | "
        f"final loss {loss:.4f} | skipped {rep['notfinite_count']} | "
        f"injected {len(sdc.injections)} | repairs {repairs} (per fsdp "
        f"group: {group_repairs}) | per-shard replica variants {variants}")

    ok = True
    if not finite(loss):
        ok = not fail("final loss non-finite over the 2-D mesh")
    if args.nan_prob and rep["notfinite_count"] == 0:
        ok = not fail("guard never tripped — injection is not reaching the "
                      "per-shard exchanges")
    if repairs < len(sdc.injections):
        ok = not fail(f"consensus repaired {repairs} of "
                      f"{len(sdc.injections)} injected corruptions over the "
                      "2-D mesh")
    if variants > 1:
        ok = not fail("replicas still diverged within an fsdp shard after "
                      "the final audit window")
    if args.telemetry_out:
        split_rows = both_axes = 0
        for rec in tape.records:
            if "step" not in rec or "wire_bytes" not in rec:
                continue
            if "wire_bytes_ici" in rec and "wire_bytes_dcn" in rec:
                split_rows += 1
                if rec["wire_bytes_dcn"] > 0 and rec["wire_bytes_ici"] > 0:
                    both_axes += 1
        say(f"fsdp: {split_rows} telemetry rows carry the per-link split "
            f"({both_axes} with bytes on BOTH links)")
        if not split_rows:
            ok = not fail("no telemetry row carries the two-axis wire split")
    say("OK" if ok else "FAIL")
    return 0 if ok else 1
