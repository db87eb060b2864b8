"""``python -m grace_tpu_torch.resilience.smoke``: the default drill at four
gloo ranks (the guard trips, the loss stays finite, exit 0), the same run
without its fault at one rank (exit 1, as JAX's ``tools/chaos_smoke.py``:
"guard never tripped"), and the scenarios that need more ranks refused at ``--world 1``
with exit 2 before any process group is made."""

import pytest
from torch_smoke_common import records, run_smoke

from grace_tpu_torch.resilience.smoke import cli


def test_default_drill_trips_the_guard_and_exits_0(tmp_path):
    out = run_smoke(tmp_path, "--steps", 30, "--nan-prob", 0.05,
                    "--telemetry-every", 10)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[chaos_smoke] OK" in out.stdout
    recs = records(tmp_path)
    assert recs[0]["provenance"]["tool"] == "chaos_smoke"
    assert any(r.get("event") == "guard_skip" for r in recs)
    # A row a step the guard let through.
    assert sum(1 for r in recs if "wire_bytes" in r and "step" in r) >= 15


def test_a_fault_that_never_fires_exits_1(tmp_path):
    out = run_smoke(tmp_path, "--steps", 12, "--nan-prob", 0,
                    "--telemetry-every", 6, world=1)
    assert out.returncode == 1, out.stdout[-2000:]
    assert "guard never tripped" in out.stderr


@pytest.mark.parametrize("argv", [
    ["--sdc"], ["--watch"], ["--elastic"], ["--region"], ["--fsdp"],
    ["--region", "--world", "4"], ["--elastic", "--world", "4"],
    ["--sdc", "--world", "4"], ["--fsdp", "--world", "2"]],
    ids=lambda a: "_".join(x.strip("-") for x in a))
def test_wider_scenarios_exit_2_where_the_world_is_too_small(argv, capsys):
    """At one rank, or with a rank flag beyond the world (``--elastic-rank``
    and ``--sdc-rank`` default to 5, ``--region`` needs two regions of 4,
    ``--fsdp`` a dp axis of two)."""
    argv = ["--device", "cpu", *argv]
    if "--world" not in argv:
        argv += ["--world", "1"]
    assert cli.main(argv) == 2
    assert "[chaos_smoke]" in capsys.readouterr().err
