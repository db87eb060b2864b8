"""The port stands alone: no JAX, nothing of the JAX package or of the
repository's ``bench.py``, and no CUDA, nvcc or triton at import time."""

import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "grace_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]

_IMPORT_ALL = r"""
import sys
# jax, the JAX package, bench.py and triton are made unimportable; no CUDA
# is asked.
for name in ("jax", "jaxlib", "optax", "flax", "grace_tpu", "triton",
             "bench"):
    sys.modules[name] = None
import importlib, pkgutil
import grace_tpu_torch
names = [m.name for m in pkgutil.walk_packages(grace_tpu_torch.__path__,
                                               "grace_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(n for n in sys.modules
                if n.split(".")[0] in ("jax", "jaxlib", "grace_tpu", "triton",
                                       "bench")
                and sys.modules[n] is not None)
print(",".join(names), leaked)
"""

# The modules of the quantized wire path and the homomorphic path, which
# must be among those walked.
WIRE_PATH_MODULES = {
    "grace_tpu_torch.ops.packing", "grace_tpu_torch.ops.quant",
    "grace_tpu_torch.ops.wire", "grace_tpu_torch.compressors.qsgd",
    "grace_tpu_torch.compressors.signsgd",
    "grace_tpu_torch.compressors.homoqsgd",
    "grace_tpu_torch.compressors.countsketch"}
# The MNIST convergence path's modules and the two-shot codec.
MNIST_PATH_MODULES = {
    "grace_tpu_torch.data", "grace_tpu_torch.models.lenet",
    "grace_tpu_torch.models.threefry", "grace_tpu_torch.compressors.fp16",
    "grace_tpu_torch.examples", "grace_tpu_torch.examples.mnist10k_lenet"}
# The hierarchical path's modules: randomk and the wire-byte accounting.
HIER_PATH_MODULES = {
    "grace_tpu_torch.compressors.randomk", "grace_tpu_torch.utils",
    "grace_tpu_torch.utils.metrics"}
# The rest of the codec catalog.
CATALOG_MODULES = {
    f"grace_tpu_torch.compressors.{m}" for m in (
        "powersgd", "dgc", "efsignsgd", "cyclictopk", "onebit", "terngrad",
        "natural", "threshold", "u8bit", "sketch", "adaq", "inceptionn")}
# The front end: the bridge, the optimizer, the loggers and the examples.
FRONT_END_MODULES = {
    "grace_tpu_torch.interop", "grace_tpu_torch.interop.bridge",
    "grace_tpu_torch.interop.torch", "grace_tpu_torch.utils.logging",
    "grace_tpu_torch.examples.common", "grace_tpu_torch.examples.torch_mnist",
    "grace_tpu_torch.examples.torch_synthetic_benchmark"}

# The rest of the model zoo and its examples.
MODEL_ZOO_MODULES = {
    "grace_tpu_torch.models.transformer", "grace_tpu_torch.models.vgg",
    "grace_tpu_torch.models.resnet_cifar",
    "grace_tpu_torch.examples.bert_powersgd",
    "grace_tpu_torch.examples.cifar10_dawn",
    "grace_tpu_torch.examples.synthetic_benchmark"}

# The guarded step: telemetry, the guard and the checkpoints.
GUARDED_STEP_MODULES = {
    "grace_tpu_torch.telemetry", "grace_tpu_torch.telemetry.scopes",
    "grace_tpu_torch.telemetry.state", "grace_tpu_torch.telemetry.sinks",
    "grace_tpu_torch.telemetry.reader", "grace_tpu_torch.resilience",
    "grace_tpu_torch.resilience.guard", "grace_tpu_torch.checkpoint"}

# The cross-rank health layer: watch, the detectors, the timeline, the
# consensus audit and the chaos injectors.
CROSS_RANK_MODULES = {
    "grace_tpu_torch.telemetry.aggregate", "grace_tpu_torch.telemetry.anomaly",
    "grace_tpu_torch.telemetry.timeline",
    "grace_tpu_torch.resilience.consensus",
    "grace_tpu_torch.resilience.chaos"}

# The adaptive ladder, elastic resize and the footprint model.
ADAPT_ELASTIC_MODULES = {
    "grace_tpu_torch.resilience.adapt", "grace_tpu_torch.resilience.elastic",
    "grace_tpu_torch.profiling", "grace_tpu_torch.profiling.recorder"}

# The profiler's read side and the 2-D mesh's modules.
PROFILING_MESH_MODULES = {
    "grace_tpu_torch.profiling.trace_analysis",
    "grace_tpu_torch.profiling.trace_export",
    "grace_tpu_torch.utils.profiling", "grace_tpu_torch.parallel",
    "grace_tpu_torch.train", "grace_tpu_torch.transform"}

# The static auditor and the kernel wrappers' fake branch.
ANALYSIS_MODULES = {
    "grace_tpu_torch.analysis", "grace_tpu_torch.ops.fake",
    *(f"grace_tpu_torch.analysis.{m}" for m in (
        "trace", "passes", "flow", "configs", "report", "__main__"))}

# The auditor's repo rules and state passes, and the tuner.
STATE_TUNING_MODULES = {
    "grace_tpu_torch.analysis.rules", "grace_tpu_torch.analysis.state_passes",
    "grace_tpu_torch.tuning",
    *(f"grace_tpu_torch.tuning.{m}" for m in (
        "cost", "candidates", "prune", "measure", "online", "__main__"))}

# The online re-tuner, the evidence package and the controllers' trails.
RETUNE_EVIDENCE_MODULES = {
    "grace_tpu_torch.resilience.retune", "grace_tpu_torch.telemetry.report",
    "grace_tpu_torch.evidence",
    *(f"grace_tpu_torch.evidence.{m}" for m in (
        "ledger", "staleness", "gate", "incident", "backfill", "summary"))}


def test_every_module_imports_without_jax_or_triton():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    names, leaked = out.stdout.split(maxsplit=1)
    names = set(names.split(","))
    assert len(names) >= 20                      # every module of the port
    assert WIRE_PATH_MODULES <= names
    assert MNIST_PATH_MODULES <= names
    assert HIER_PATH_MODULES <= names
    assert CATALOG_MODULES <= names
    assert FRONT_END_MODULES <= names
    assert MODEL_ZOO_MODULES <= names
    assert GUARDED_STEP_MODULES <= names
    assert CROSS_RANK_MODULES <= names
    assert ADAPT_ELASTIC_MODULES <= names
    assert PROFILING_MESH_MODULES <= names
    assert ANALYSIS_MODULES <= names
    assert STATE_TUNING_MODULES <= names
    assert RETUNE_EVIDENCE_MODULES <= names
    assert leaked.strip() == "[]"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_sources_name_no_jax(path):
    text = path.read_text()
    assert "grace_tpu." not in text
    assert "import jax" not in text
    assert not re.search(
        r"^\s*(from|import)\s+(jax|optax|flax|grace_tpu|bench)\b", text,
        re.M)


def test_kernel_source_is_in_the_package():
    cu = {p.name: p.read_text() for p in (PORT / "csrc").glob("*.cu")}
    assert sorted(cu) == ["chunk_topk.cu", "quant.cu", "wire.cu"]
    # Each names the TPU kernels it replaces.
    assert "pallas_topk.py" in cu["chunk_topk.cu"]
    assert "pallas_quant.py" in cu["quant.cu"]
    assert "pallas_wire.py" in cu["wire.cu"]
