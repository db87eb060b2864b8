"""Shared plumbing of the port's examples: the GRACE flags, the synthetic
MNIST set, and the ranks. Its own copy of what it needs from the
repository's ``examples/common.py`` (``add_grace_args``,
``grace_params_from_args``, ``synthetic_mnist``), which imports the JAX
package; the MNIST files and minibatches are in ``grace_tpu_torch.data``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from grace_tpu_torch.parallel import init_process_group

GRACE_FLAG_DOC = """GRACE compression flags (the reference's params-dict
schema): --compressor/--memory/--communicator select the triad; each
algorithm's hyperparameters have the reference's defaults."""


def add_grace_args(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("grace", GRACE_FLAG_DOC)
    g.add_argument("--compressor", default="none",
                   help="none|fp16|topk|randomk|threshold|qsgd|homoqsgd|"
                        "countsketch|terngrad|signsgd|signum|efsignsgd|"
                        "onebit|natural|dgc|powersgd|u8bit|sketch|adaq|"
                        "inceptionn")
    g.add_argument("--memory", default="none",
                   help="none|residual|efsignsgd|dgc|powersgd")
    g.add_argument("--communicator", default="allgather",
                   help="allreduce|allgather|broadcast|sign_allreduce|"
                        "twoshot|ring|hier|identity")
    g.add_argument("--slice-size", type=int, default=None,
                   help="with --communicator hier: ranks per slice (the "
                        "two-level schedule needs whole slices)")
    g.add_argument("--compress-ratio", type=float, default=0.01)
    g.add_argument("--quantum-num", type=int, default=64)
    g.add_argument("--threshold", type=float, default=0.01)
    g.add_argument("--momentum", type=float, default=0.9)
    g.add_argument("--compress-rank", type=int, default=4,
                   help="PowerSGD rank")
    g.add_argument("--fusion", default="flat",
                   help="flat|grouped|none|<bytes> — gradient fusion buffer")
    g.add_argument("--topk-algorithm", default="exact",
                   help="exact|approx|chunk — top-k selection strategy")
    g.add_argument("--recall-target", type=float, default=0.95,
                   help="recall for --topk-algorithm approx")
    g.add_argument("--use-pallas", default="auto",
                   choices=["auto", "on", "off"],
                   help="the kernel path (auto, on) or the staged one (off)")
    g.add_argument("--memory-dtype", default=None,
                   help="storage dtype of the residual (e.g. bfloat16)")
    g.add_argument("--seed", type=int, default=42)


def grace_params_from_args(args) -> dict:
    fusion = args.fusion
    if fusion in ("none", "None", ""):
        fusion = None
    elif fusion not in ("flat", "grouped"):
        fusion = int(fusion)
    params = {
        "compressor": args.compressor,
        "memory": args.memory,
        "communicator": args.communicator,
        "compress_ratio": args.compress_ratio,
        "quantum_num": args.quantum_num,
        "threshold": args.threshold,
        "momentum": args.momentum,
        "compress_rank": args.compress_rank,
        "fusion": fusion,
        "topk_algorithm": args.topk_algorithm,
        "recall_target": args.recall_target,
    }
    if getattr(args, "slice_size", None):
        params["slice_size"] = args.slice_size
    if args.use_pallas != "auto":
        params["use_pallas"] = args.use_pallas == "on"
    if getattr(args, "memory_dtype", None):
        if args.memory != "residual":
            raise SystemExit(
                f"--memory-dtype applies only to --memory residual "
                f"(got --memory {args.memory})")
        params["memory_dtype"] = args.memory_dtype
    return params


def add_rank_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (NCCL, one card a rank) or cpu (gloo)")
    parser.add_argument("--nproc", type=int, default=1,
                        help="ranks to spawn, one process each")


def _synthetic_classification(n, seed, shape, noise, proto_seed):
    """Class-conditional data: 10 fixed prototype images plus noise a
    sample. The prototypes come from ``proto_seed``, so splits made with
    different ``seed`` values share one task."""
    protos = np.random.default_rng(proto_seed).standard_normal(
        (10, *shape)).astype(np.float32)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, n).astype(np.int32)
    x = protos[y] + noise * rng.standard_normal((n, *shape)).astype(np.float32)
    return x, y


def synthetic_mnist(n: int, seed: int = 0, proto_seed: int = 1234):
    """Synthetic 28×28×1 digits, separable enough that LeNet passes 95%
    quickly (NHWC, as the JAX package makes them)."""
    return _synthetic_classification(n, seed, (28, 28, 1), 0.3, proto_seed)


def _worker(rank, world, init_method, main, argv, device):
    if device == "cpu":
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    group, dev = init_process_group(
        "cpu" if device == "cpu" else f"cuda:{rank}", rank=rank,
        world_size=world, init_method=init_method)
    try:
        main(argv, group, dev)
    finally:
        dist.destroy_process_group()


def run_ranks(main, argv, args) -> None:
    """Run ``main(argv, group, device)`` as ``args.nproc`` spawned ranks,
    or in this process as the one rank of a world-size-1 group."""
    if args.nproc > 1:
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(
                _worker, args=(args.nproc, f"file://{tmp}/store", main, argv,
                               args.device),
                nprocs=args.nproc, join=True, start_method="spawn")
        return
    group, dev = init_process_group(args.device)
    try:
        main(argv, group, dev)
    finally:
        dist.destroy_process_group()
