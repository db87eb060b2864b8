"""Device ms a step of the operations launched inside PyTorch's
``nccl:*`` ranges (each collective the program issues through
``torch.distributed``): NCCL's kernels at W > 1, the copies a one-rank
collective makes at W = 1, rank 0."""


def read(run):
    ops = run.trace.launched_in("nccl:", prefix=True)
    if not ops:
        return None
    return sum(o.dur for o in ops) / 1e3 / run.trace.steps
