"""The chunk aggregate kernel's share of its bound, from the trace: the
bytes it must move, ``4·N + 8·W·K`` over the cell's leaves and W ranks
(``counts/chunk_topk.py``), at 3.35 TB/s, over its device time a step, in
%. Nothing where the trace holds no launch of it."""

from portbench.counts.chunk_topk import aggregate_bytes
from portbench.counts.peaks import HBM_BYTES_PER_S

KERNEL = "chunk_aggregate_dense_kernel"


def read(run):
    ops = [o for o in run.trace.kernels() if KERNEL in o.name]
    if not ops:
        return None
    ratio = run.cell.mix["grace"]["compress_ratio"]
    bound_s = aggregate_bytes(run.leaf_sizes, ratio, run.world) \
        / HBM_BYTES_PER_S
    kernel_s = sum(o.dur for o in ops) / 1e6 / run.trace.steps
    return 100.0 * bound_s / kernel_s
