"""Starting a run's ranks and printing its result.

A one-chip cell runs in the calling process. A cell of W chips starts W
processes (``harness/rank.py``), one a card, joined over a free loopback
port; the port's kernels are built once, before they start. Rank 0 reads
the metrics (``metrics/<name>.py``) and hands the result line back; the
calling process prints it after every rank has ended.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

from portbench.harness import manifest, worker

RANK_SCRIPT = manifest.BENCH_DIR / "harness" / "rank.py"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _number(v: Optional[float]) -> Optional[float]:
    return None if v is None or not math.isfinite(v) else float(v)


def device_info(world: int, device: str) -> Dict[str, Any]:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": world}
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": world}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def result_line(pieces: Dict[str, Any], spec: Dict[str, Any]
                ) -> Tuple[Dict[str, Any], List[str]]:
    """The contract's last line and the lines that show the comparison."""
    record = pieces["record"]
    cell = record.cell
    kind = "per_layer" if spec["trace"] else "end_to_end"
    metrics = {}
    for m in (cell.per_layer if spec["trace"] else cell.end_to_end):
        value = _number(cell.metric_reader(m["name"]).read(record))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = device_info(record.world, spec["device"])
    device["memory_peak_bytes"] = pieces["memory_peak_bytes"]
    line: Dict[str, Any] = {"correct": pieces["correct"],
                            "attempted": pieces["attempted"],
                            "failed": pieces["failed"],
                            "metrics": metrics, "device": device}
    if spec["trace"]:
        from portbench.harness.trace import breakdown
        device["busy_s"] = pieces["busy_s"]
        device["window_s"] = pieces["window_s"]
        line["breakdown"] = breakdown(record.trace)
    checked, lines = {}, []
    if spec["trace"]:
        traced_ms = record.trace.window_us / 1e3 / record.trace.steps
        lead_ms = 1e3 * record.lead_s / record.lead_steps
        lines.append(f"traced step {traced_ms!r} ms; untraced step "
                     f"{lead_ms!r} ms (the steps before the profiler started)")
    for name, value, limit, where in pieces["rows"]:
        if limit is not None:
            checked[name] = {"value": _number(value), "limit": limit}
        lines.append(f"check {name} {value!r} limit "
                     f"{'none (not compared)' if limit is None else limit}"
                     f" (worst at {where})")
    lines.append(f"check correct {line['correct']} ({kind} run, "
                 f"{line['failed']} of {line['attempted']} steps failed)")
    line["checked"] = checked
    return line, lines


def rank_main(spec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Run one rank; rank 0 returns what the calling process prints."""
    pieces = worker.run_rank(spec)
    if pieces is None:
        return None
    if spec.get("mode") == "readings":
        return {"readings": pieces}
    line, lines = result_line(pieces, spec)
    return {"line": line, "checks": lines}


def execute(spec: Dict[str, Any], world: int,
            timeout_s: float = 1500.0) -> Dict[str, Any]:
    """Run ``spec`` on ``world`` ranks; rank 0's output. Raises where a
    rank fails."""
    if world == 1:
        out = rank_main(dict(spec, rank=0, world=1, init_method=None))
        return out
    if spec["device"] == "cuda":
        from grace_tpu_torch.ops import _build
        _build.build_all()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = []
    out_file = tempfile.TemporaryFile("w+")
    for rank in range(world):
        rank_spec = dict(spec, rank=rank, world=world, init_method=init)
        procs.append(subprocess.Popen(
            [sys.executable, str(RANK_SCRIPT), json.dumps(rank_spec)],
            stdout=out_file if rank == 0 else subprocess.DEVNULL))
    deadline = time.monotonic() + timeout_s
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    with out_file:
        out_file.seek(0)
        out_text = out_file.read()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"a rank failed: exit codes {codes}")
    return json.loads(out_text.strip().splitlines()[-1])


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port builds its kernels into ``grace_tpu_torch/_build`` by
    itself; Triton's and torch's extension caches, should anything use
    them, go under ``.portbench_cache``."""
    root = manifest.ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(root / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "torch_extensions")
