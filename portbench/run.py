#!/usr/bin/env python3
"""Run one cell of grace_tpu_torch's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up builds the cell's training step from the seed and drives it
through its first steps; the window then runs the step for about
``--seconds``; with ``--trace 1`` its last steps run in one profiler
session. After the window the plain reference follows the first steps and
decides ``correct``. The last line of standard output is the result; the
comparison's numbers and limits are the last lines of standard error.
Exits 1 without a result where there is no card, fewer cards than the
cell asks for, or the run fails.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# Four times CUDA's default queue of pending launches, read when the first
# context is made: the host runs further ahead of the card, so a short
# stall of the host leaves the card fed. Every rank inherits it.
os.environ["CUDA_SCALE_LAUNCH_QUEUES"] = "4x"
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import launch, manifest, worker  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    launch.cache_dirs()
    cell = manifest.resolve(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} asks for {cell.chips} cards; "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    spec = {"workload": args.workload, "seed": args.seed,
            "seconds": args.seconds, "trace": bool(args.trace),
            "device": "cuda", "t0": T0}
    out = launch.execute(spec, cell.chips)
    found = worker.banned_modules()
    if found:
        print(f"loaded {found}: the benchmark runs without JAX",
              file=sys.stderr)
        return 1
    print("\n".join(out["checks"]), file=sys.stderr, flush=True)
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
