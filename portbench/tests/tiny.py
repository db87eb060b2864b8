"""Tiny cells for the CPU tests: the real configurations and mixes with
their widths cut, written next to a copy of the manifest."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

from portbench.harness import manifest

TINY = {
    "resnet50": dict(blocks=[1, 1, 0, 0], image_size=16, batch_per_chip=4,
                     num_classes=10),
    "bert_base": dict(vocab_size=300, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=64,
                      max_position_embeddings=32, seq_len=16,
                      batch_per_chip=4),
}

# The four-rank cell, out of the manifest until it is measured at the
# manifest's window (PERF.md, open questions); its mix and limits stay, and
# the tests of the exchange run it on two ranks.
W4 = {"name": "resnet50_topk1pct_w4", "config": "resnet50",
      "traffic": "topk1pct_4ranks", "chips": 4,
      "why": "the exchange across ranks"}

# In float32 the port and the reference agree to rounding: the tests hold
# them to this, and every fault and the control miss it by far.
TIGHT = 1e-4
NUMBERS = ("loss_gap", "update_gap", "change_gap", "residual_gap")


def tiny_manifest(tmp: Path, **override) -> dict:
    """The manifest with every configuration cut to its tiny widths (and
    ``override`` applied, as ``compute_dtype="float32"``)."""
    m = copy.deepcopy(manifest.load_json(manifest.MANIFEST))
    for c in m["configs"]:
        cfg = manifest.load_json(manifest.ROOT / c["file"])
        cfg.update(TINY[c["name"]], **override)
        path = tmp / f"{c['name']}.json"
        path.write_text(json.dumps(cfg))
        c["file"] = str(path)
    if all(w["name"] != W4["name"] for w in m["workloads"]):
        m["workloads"].append(dict(W4))
    return m


def spec(m: dict, workload: str, **kw) -> dict:
    s = {"workload": workload, "seed": 2 ** 31 + 17, "seconds": 0.05,
         "trace": False, "device": "cpu", "t0": time.time(), "manifest": m,
         "limits": {"limits": {n: TIGHT for n in NUMBERS}}}
    if not manifest.resolve(workload, m, limits={}).reference_codec() \
            .Codec.has_residual:
        del s["limits"]["limits"]["residual_gap"]
    s.update(kw)
    return s
