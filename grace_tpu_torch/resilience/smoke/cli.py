"""The command line of ``python -m grace_tpu_torch.resilience.smoke``: the
chaos drills of the repository's ``tools/chaos_smoke.py`` on the port,
one process a rank (the ranks are spawned from this module, so their
entry point pickles by name).

    python -m grace_tpu_torch.resilience.smoke --world 8 --device cpu
    python -m grace_tpu_torch.resilience.smoke --world 8 --device cpu --sdc
    python -m grace_tpu_torch.resilience.smoke --world 8 --device cpu \\
        --sdc --hier --slice-size 4
    python -m grace_tpu_torch.resilience.smoke --world 8 --device cpu --watch
    python -m grace_tpu_torch.resilience.smoke --world 8 --device cpu --adapt
    python -m grace_tpu_torch.resilience.smoke --world 8 --device cpu \\
        --elastic
    python -m grace_tpu_torch.resilience.smoke --world 8 --device cpu \\
        --region
    python -m grace_tpu_torch.resilience.smoke --world 8 --device cpu \\
        --retune
    python -m grace_tpu_torch.resilience.smoke --world 8 --device cpu --fsdp
    python -m grace_tpu_torch.resilience.smoke --adapt --adapt-rank 0

The flags are ``tools/chaos_smoke.py``'s, with its defaults, plus
``--world`` (ranks, one process each; gloo on the CPU, NCCL on the cards)
and ``--device`` (``cuda``, the default, or ``cpu``), and ``--ledger``
(the evidence ledger a document's record goes to; by default the port's
own, for a document written to its default place in ``grace_tpu_torch/``).
Outputs default to ``grace_tpu_torch/`` (``chaos_telemetry.jsonl``,
``ADAPT_LAST.json``, ``ELASTIC_LAST.json``, ``REGION_LAST.json``,
``RETUNE_LAST.json``), never the repository root's JAX documents.

Exit status: 0 every acceptance fact of the scenario held on every rank;
1 one failed (or a rank crashed); 2 the scenario needs more ranks than
``--world`` gives (``--sdc``, ``--watch``, ``--elastic``, ``--region``
below two regions, ``--fsdp`` beyond 1×1), a rank flag names no rank of
the world, or a bad argument.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import traceback

from grace_tpu_torch.resilience.smoke.common import default_path

PROG = "python -m grace_tpu_torch.resilience.smoke"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=PROG, description="Chaos drills of the port: the guard, the "
        "consensus audit, the watch, the adaptive ladder, elastic and "
        "region resizes, online re-tuning and the dp×fsdp mesh under "
        "injected faults.")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--nan-prob", type=float, default=0.01,
                    help="per-(step, leaf) NaN implant probability")
    ap.add_argument("--rank", type=int, default=0,
                    help="rank the faults land on")
    ap.add_argument("--batch", type=int, default=32,
                    help="global batch (split over the ranks)")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--fallback-after", type=int, default=3)
    ap.add_argument("--fallback-steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry-out",
                    default=default_path("chaos_telemetry.jsonl"),
                    help="JSONL telemetry artifact path ('' disables)")
    ap.add_argument("--telemetry-every", type=int, default=25,
                    help="steps per telemetry flush")
    ap.add_argument("--incidents", default="",
                    help="directory for flight-recorder incident "
                         "snapshots ('' disables)")
    ap.add_argument("--sdc", action="store_true",
                    help="also inject single-rank param SDC (ChaosParams) "
                         "and require the consensus auditor to repair it")
    ap.add_argument("--sdc-rank", type=int, default=5,
                    help="rank whose param replica gets the bitflips")
    ap.add_argument("--sdc-steps", default="",
                    help="comma-separated injection steps (default: two "
                         "hits at 1/3 and 2/3 of --steps)")
    ap.add_argument("--audit-every", type=int, default=20,
                    help="consensus audit interval (with --sdc)")
    ap.add_argument("--profile", action="store_true",
                    help="record step-time percentiles, kernel builds, "
                         "memory watermarks and the GraceState footprint "
                         "check into the telemetry artifact")
    ap.add_argument("--hier", action="store_true",
                    help="run over the hierarchical communicator "
                         "(communicator='hier', fusion='flat')")
    ap.add_argument("--slice-size", type=int, default=4,
                    help="with --hier: ranks per slice")
    ap.add_argument("--homo", action="store_true",
                    help="run over the shared-scale homomorphic codec "
                         "(compressor='homoqsgd')")
    ap.add_argument("--watch", action="store_true",
                    help="seed a single-rank compression-error drift and "
                         "require a watch_anomaly naming that rank within "
                         "one watch window, the guard silent")
    ap.add_argument("--watch-rank", type=int, default=3,
                    help="rank whose encoder drifts (with --watch)")
    ap.add_argument("--drift-scale", type=float, default=0.5,
                    help="payload attenuation of the drifting rank")
    ap.add_argument("--watch-window", type=int, default=10,
                    help="steps between cross-rank health summaries")
    ap.add_argument("--adapt", action="store_true",
                    help="adaptive-controller drill: drift -> tighten "
                         "before any guard event; quiet -> loosen; NaN -> "
                         "the guard trips and the controller escalates")
    ap.add_argument("--adapt-window", type=int, default=8,
                    help="controller decision window in steps")
    ap.add_argument("--adapt-rank", type=int, default=3,
                    help="rank whose encoder drifts in the drift phase")
    ap.add_argument("--adapt-out", default=default_path("ADAPT_LAST.json"),
                    help="evidence JSON path for --adapt ('' disables)")
    ap.add_argument("--elastic", action="store_true",
                    help="drift -> watch drain -> the flagged rank (its "
                         "slice with --hier) leaves -> W-1 -> rejoin at W "
                         "behind the consensus barrier")
    ap.add_argument("--elastic-rank", type=int, default=5,
                    help="rank that degrades and leaves (with --elastic)")
    ap.add_argument("--elastic-out",
                    default=default_path("ELASTIC_LAST.json"),
                    help="evidence JSON path for --elastic ('' disables)")
    ap.add_argument("--region", action="store_true",
                    help="cross-region drill: 2 regions x 2 slices x 2 "
                         "ranks, drift in one region -> one region-wide "
                         "drain -> the region leaves -> W-4 -> the region "
                         "rejoins behind the consensus barrier")
    ap.add_argument("--region-size", type=int, default=4,
                    help="ranks per region for --region")
    ap.add_argument("--region-out", default=default_path("REGION_LAST.json"),
                    help="evidence JSON path for --region ('' disables)")
    ap.add_argument("--retune", action="store_true",
                    help="online re-tuning drill: fleet drift -> a "
                         "two-phase promotion -> probation -> promotion "
                         "back -> a sabotaged promotion demoted bit for "
                         "bit within its probation")
    ap.add_argument("--retune-window", type=int, default=6,
                    help="controller drift window in telemetry rows")
    ap.add_argument("--retune-probation", type=int, default=18,
                    help="probation steps after each promotion")
    ap.add_argument("--retune-funnel", action="store_true",
                    help="with --retune: re-run the tuner's bounded static "
                         "and measured funnel after the drift verdict")
    ap.add_argument("--retune-out", default=default_path("RETUNE_LAST.json"),
                    help="evidence JSON path for --retune ('' disables)")
    ap.add_argument("--drain-timeout", type=float, default=60.0,
                    help="drain and transition watchdog seconds (0 "
                         "disables the watchdog)")
    ap.add_argument("--floor", type=float, default=2.25,
                    help="convergence floor: the post-rejoin final loss "
                         "must be below this")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: a fresh temp "
                         "dir)")
    ap.add_argument("--fsdp", action="store_true",
                    help="the chaos matrix over a dp x fsdp mesh: a "
                         "tensor-parallel MLP, the routed rscatter "
                         "exchange, NaN injection and single-rank SDC "
                         "repaired per fsdp shard")
    ap.add_argument("--fsdp-size", type=int, default=2,
                    help="fsdp axis width (dp = world // fsdp_size)")
    ap.add_argument("--lint", action="store_true",
                    help="first run the static auditor (repo rules and "
                         "this run's config); findings fail the drill")
    ap.add_argument("--pipeline", type=int, default=0,
                    help="ride the double-buffered wire path: packed "
                         "qsgd over a ring with pipeline=N segments")
    ap.add_argument("--world", type=int, default=1,
                    help="ranks, one process each")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one card a rank) or cpu (gloo)")
    ap.add_argument("--ledger", default=None,
                    help="evidence ledger for the documents' records "
                         "(default: the port's, for a document at its "
                         "default place)")
    return ap


def scenario(args):
    """The drill module's ``run(args, argv, group, device)``."""
    import importlib
    name = next((n for n in ("adapt", "retune", "elastic", "region", "fsdp")
                 if getattr(args, n)), "base")
    return importlib.import_module(
        f"grace_tpu_torch.resilience.smoke.{name}").run


def world_check(args):
    """Why ``--world`` cannot run the scenario (None: it can)."""
    w = args.world
    if w < 1:
        return f"--world {w}: need at least one rank"

    def no_rank(flag, r):
        return None if 0 <= r < w else \
            f"{flag} {r} is not a rank of a world of {w}"

    if args.region:
        rz = args.region_size
        if rz < 2 or w % rz or w // rz < 2:
            return (f"--region needs at least two whole regions of "
                    f"--region-size {rz} (>= 2) ranks; --world {w} gives "
                    f"{w // max(rz, 1)}")
        return None
    if args.fsdp:
        f = max(1, args.fsdp_size)
        if w == 1 and f == 1:
            return no_rank("--rank", args.rank)
        if w % f or w // f < 2:
            return (f"--fsdp needs a dp x fsdp mesh with dp >= 2: --world "
                    f"{w} over --fsdp-size {f}")
        return no_rank("--sdc-rank", args.sdc_rank) or \
            no_rank("--rank", args.rank)
    if args.elastic:
        if w < 2:
            return "--elastic needs W > 1: a rank leaves and rejoins"
        if args.hier and (w % args.slice_size or w // args.slice_size < 2):
            return (f"--elastic --hier needs at least two whole slices of "
                    f"--slice-size {args.slice_size}; --world {w}")
        return no_rank("--elastic-rank", args.elastic_rank)
    if args.adapt:
        return no_rank("--adapt-rank", args.adapt_rank) or \
            no_rank("--rank", args.rank)
    if args.retune:
        return no_rank("--rank", args.rank)
    if args.sdc and w < 2:
        return "--sdc needs W > 1: the audit repairs one replica from the " \
               "others"
    if args.watch and w < 2:
        return "--watch needs W > 1: the watch attributes a skew across " \
               "ranks"
    return (no_rank("--rank", args.rank)
            or (no_rank("--sdc-rank", args.sdc_rank) if args.sdc else None)
            or (no_rank("--watch-rank", args.watch_rank) if args.watch
                else None))


def _rank_main(rank, world, init_method, argv, device, rc_dir):
    import torch
    import torch.distributed as dist

    from grace_tpu_torch.parallel import init_process_group

    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    group, dev = init_process_group(
        "cpu" if device == "cpu" else f"cuda:{rank}", rank=rank,
        world_size=world, init_method=init_method)
    rc = 1
    try:
        args = build_parser().parse_args(argv)
        rc = scenario(args)(args, argv, group, dev)
    finally:
        with open(os.path.join(rc_dir, f"rank{rank}"), "w") as f:
            f.write(str(rc))
        dist.destroy_process_group()


def launch(args, argv) -> int:
    """Run the drill on ``args.world`` ranks; the run's exit code."""
    if args.world == 1:
        import torch.distributed as dist

        from grace_tpu_torch.parallel import init_process_group
        group, dev = init_process_group(args.device)
        try:
            return scenario(args)(args, argv, group, dev)
        finally:
            dist.destroy_process_group()
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="grace-smoke-") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(args.world, f"file://{tmp}/store", argv,
                              args.device, tmp),
            nprocs=args.world, join=False, start_method="spawn")
        try:
            while not ctx.join():
                pass
        except Exception:                          # noqa: BLE001
            traceback.print_exc()
            return 1
        rcs = []
        for r in range(args.world):
            path = os.path.join(tmp, f"rank{r}")
            rcs.append(int(open(path).read()) if os.path.exists(path)
                       else 1)
    return 0 if all(rc == 0 for rc in rcs) else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    why = world_check(args)
    if why is not None:
        print(f"[chaos_smoke] {why}", file=sys.stderr)
        return 2
    return launch(args, argv)
