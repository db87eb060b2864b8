"""Samples of all ranks whose steps finished in the window, over the
window's seconds on the host clock: from just before the first step's
start event (the card idle after a synchronise) to the final
synchronise."""


def read(run):
    return run.world * run.batch * run.steps / run.window_s
