"""The share of the traced window in which no device operation ran:
1 − the union of every kernel, copy and set interval over the window,
in %, rank 0."""


def read(run):
    return 100.0 * (1.0 - run.trace.busy_us() / run.trace.window_us)
