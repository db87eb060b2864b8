"""Whole runs on the CPU at a tiny width, the card's check skipped, with
the timed path broken underneath: ``correct`` comes out false for each
fault a training cell can have, and true for the sound step. The step
computes in float32 here, where it meets the reference to rounding, so
one tight limit serves every cell. The last tests judge the faults and
the control by each cell's own limits (``limits/<cell>.json``), with the
step in its configured bfloat16."""

import pytest

from portbench.harness import launch
from portbench.tests.tiny import spec, tiny_manifest


@pytest.fixture(scope="module")
def manifest_dict(tmp_path_factory):
    return tiny_manifest(tmp_path_factory.mktemp("tiny"),
                         compute_dtype="float32")


@pytest.mark.parametrize("cell", ["resnet50_topk1pct", "bert_base_topk1pct"])
def test_sound_run_is_correct(manifest_dict, cell):
    out = launch.execute(spec(manifest_dict, cell), 1)
    assert out["line"]["correct"] is True, out["checks"]
    assert list(out["line"])[-1] == "checked"
    assert out["checks"][-1].startswith("check correct True")


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", ["resnet50_topk1pct", "bert_base_topk1pct"])
def test_fault_makes_the_run_incorrect(manifest_dict, cell, fault):
    out = launch.execute(spec(manifest_dict, cell, fault=fault), 1)
    assert out["line"]["correct"] is False, (fault, out["checks"])


def test_exchange_left_out_is_incorrect(manifest_dict):
    """Two gloo ranks in processes of their own; each rank's GRACE
    exchange over a group of itself alone."""
    out = launch.execute(spec(manifest_dict, "resnet50_topk1pct_w4",
                              fault="no_exchange"), 2, timeout_s=600)
    assert out["line"]["correct"] is False, out["checks"]
    assert out["line"]["device"]["count"] == 2


@pytest.fixture(scope="module")
def configured(tmp_path_factory):
    """The tiny cells computing in their configured precision."""
    return tiny_manifest(tmp_path_factory.mktemp("tiny_configured"))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", ["resnet50_topk1pct", "bert_base_topk1pct"])
def test_fault_fails_the_cells_own_limits(configured, cell, fault):
    out = launch.execute(spec(configured, cell, fault=fault, limits=None), 1)
    assert out["line"]["correct"] is False, (fault, out["checks"])


def test_exchange_left_out_fails_the_cells_own_limits(configured):
    out = launch.execute(spec(configured, "resnet50_topk1pct_w4",
                              fault="no_exchange", limits=None), 2,
                         timeout_s=600)
    assert out["line"]["correct"] is False, out["checks"]


@pytest.mark.parametrize("seed", [5, 2 ** 33 + 1])
def test_control_run_fails_the_cells_own_limits(configured, seed):
    """The reference in float8 in the program's place, through a whole
    run. BERT's cell only: the ResNet cells' control reads a median-leaf
    gap near 0.04 at any width the CPU holds, under their 0.07, since its
    error grows with the depth and the batch; the card test of
    ``test_portbench_harness`` holds them at the cell's own size."""
    out = launch.execute(spec(configured, "bert_base_topk1pct",
                              fault="control", limits=None, seed=seed), 1)
    assert out["line"]["correct"] is False, out["checks"]
