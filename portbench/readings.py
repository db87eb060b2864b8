#!/usr/bin/env python3
"""Read the comparison's numbers of a cell on many seeds, with no window:
the sound program, faults planted in it, and the control.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \\
        --variants program,control,half_batch,no_exchange

``program``: the cell's own training step. ``half_batch``: its loss over
the first half of each batch. ``no_exchange``: its GRACE exchange over a
group of this rank alone (W > 1). ``unchanged``: its optimizer's step
does nothing. ``control``: the plain reference computed in float8 in the
program's place. Each reading is compared with the float32 reference of
the same seed. Prints one JSON line a seed and variant; the limits in
``limits/<cell>.json`` are set from these readings (README.md).
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import launch, manifest  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="program,control")
    p.add_argument("--dump", default="",
                   help="also write every leaf's norms to this file")
    args = p.parse_args(argv)
    launch.cache_dirs()
    cell = manifest.resolve(args.workload)
    import torch
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} asks for {cell.chips} cards", file=sys.stderr)
        return 1
    spec = {"mode": "readings", "workload": args.workload,
            "seeds": [int(s) for s in args.seeds.split(",")],
            "variants": args.variants.split(","), "device": "cuda",
            "t0": T0, "seed": 0, "seconds": 0, "trace": False,
            "dump": bool(args.dump)}
    out = launch.execute(spec, cell.chips, timeout_s=3000.0)
    if args.dump:
        Path(args.dump).parent.mkdir(parents=True, exist_ok=True)
        with open(args.dump, "w") as f:
            for row in out["readings"]:
                f.write(json.dumps(row) + "\n")
    for row in out["readings"]:
        for key in ("leaves", "reference", "loss", "reference_loss", "names"):
            row.pop(key, None)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
