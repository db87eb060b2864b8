"""Device ms a step of the kernels launched inside the program's
``grace/forward_backward`` ranges (by launch correlation; the model's
forward and backward), rank 0."""


def read(run):
    ops = run.trace.launched_in("grace/forward_backward")
    if not ops:
        return None
    return sum(o.dur for o in ops) / 1e3 / run.trace.steps
