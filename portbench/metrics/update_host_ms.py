"""Host ms a step of the program's ``grace/optimizer`` ranges: what the
exchange and the optimizer cost the host to enqueue, rank 0."""


def read(run):
    spans = run.trace.ranges("grace/optimizer")
    if not spans:
        return None
    return sum(s.dur for s in spans) / 1e3 / run.trace.steps
