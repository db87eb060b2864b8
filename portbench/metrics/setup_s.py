"""Seconds from the process's start to the first timed step: the
imports, the card's context, the process group, the weights and inputs,
the checked first steps and the warm-up (the first run in a checkout
also builds the port's kernels)."""


def read(run):
    return run.setup_s
