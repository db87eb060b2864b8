"""Device ms a step of the kernels launched inside the program's
``grace/optimizer`` ranges, nested stages included: the GRACE exchange
(compress, collectives, aggregate) and the optimizer's step, rank 0."""


def read(run):
    ops = run.trace.launched_in("grace/optimizer")
    if not ops:
        return None
    return sum(o.dur for o in ops) / 1e3 / run.trace.steps
