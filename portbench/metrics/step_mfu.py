"""The whole step's share of the chip's bf16 peak: the model's operations
a step (``counts/<family>.py``: forward and backward, 3× the forward's
matrix products and convolutions) over the time a step and 989 TFLOP/s,
in %. The time a step is that of the traced run's steps before its
profiler started (host clock, between synchronises): the profiler's host
cost slows the profiled steps. The W ranks' operations over W chips'
peak is one rank's over one chip's."""

from portbench.counts.peaks import BF16_FLOP_PER_S


def read(run):
    if not run.lead_steps:
        return None
    flops = run.cell.counts().step_flops(run.cell.config, run.batch)
    step_s = run.lead_s / run.lead_steps
    return 100.0 * flops / step_s / BF16_FLOP_PER_S
