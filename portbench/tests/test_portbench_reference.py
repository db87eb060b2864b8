"""The port's training step against the plain reference on the CPU, at a
tiny width: the port computing in float32 (the witness of
``readings.py``) agrees with the reference to rounding on every number
the benchmark compares, for both models; the reference in
float8 (the control) fails the same comparison."""

import pytest

from portbench.harness import launch
from portbench.tests.tiny import NUMBERS, TIGHT, spec, tiny_manifest

CELLS = ("resnet50_topk1pct", "bert_base_topk1pct")


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    m = tiny_manifest(tmp_path_factory.mktemp("tiny"))
    out = {}
    for cell in CELLS:
        s = spec(m, cell, mode="readings", seeds=[5, 2 ** 33 + 1],
                 variants=["program_float32", "control"])
        for row in launch.execute(s, 1)["readings"]:
            out.setdefault((cell, row["variant"]), []).append(row)
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_port_step_matches_reference(readings, cell):
    for row in readings[(cell, "program_float32")]:
        numbers = row["numbers"]
        for name in NUMBERS:
            if name in numbers:
                assert numbers[name] <= TIGHT, (cell, name, numbers)


@pytest.mark.parametrize("cell", CELLS)
def test_float8_control_fails_the_comparison(readings, cell):
    for row in readings[(cell, "control")]:
        numbers = row["numbers"]
        assert max(numbers[n] for n in NUMBERS if n in numbers) > 100 * TIGHT


@pytest.mark.parametrize("cell", CELLS)
def test_readings_are_judged_by_the_limits(readings, cell):
    """Each row carries ``correct`` as the limits judge its numbers."""
    assert all(r["correct"] for r in readings[(cell, "program_float32")])
    assert not any(r["correct"] for r in readings[(cell, "control")])


def test_compare_finds_the_worst_leaf_and_the_median():
    import torch
    from portbench.harness import compare

    ref = {"loss": [2.0, 2.0, 2.0], "grad": torch.ones(4),
           "update": torch.tensor([1.0, 2.0, 3.0, 4.0]),
           "change": torch.tensor([1.0, 1.0, 1.0, 1.0]), "residual": None}
    prog = {"loss": [2.0, 2.2, 2.0],
            "update": torch.tensor([[1.0, 2.0, 3.0, 2.0]]),
            "change": torch.tensor([[1.0, 1.1, 1.0, 1.0]]), "residual": None}
    found = compare.numbers(prog, ref, ["a", "b", "c", "d"])
    assert found["loss_gap"][0] == pytest.approx(0.1)
    assert found["update_gap"] == (pytest.approx(0.5), "rank 0 leaf d")
    assert found["change_gap"][0] == pytest.approx(0.1)
    assert found["change_median_gap"][0] == pytest.approx(0.0)
    ok, rows = compare.judge(found, {"loss_gap": 0.2, "update_gap": 0.4})
    assert not ok and len(rows) == len(found)
    ok, _ = compare.judge({"loss_gap": (float("nan"), "")}, {"loss_gap": 1.0})
    assert not ok
