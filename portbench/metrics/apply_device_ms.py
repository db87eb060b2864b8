"""Device ms a step of the kernels launched inside the program's
``grace/apply_updates`` ranges (by launch correlation): the optimizer's
update of the parameters from the exchanged gradients, apart from GRACE's
exchange, rank 0. Nothing where the program opens no such range."""


def read(run):
    ops = run.trace.launched_in("grace/apply_updates")
    if not ops:
        return None
    return sum(o.dur for o in ops) / 1e3 / run.trace.steps
