"""The chunk compress kernel's share of its bound, from the trace: the
bytes it must move, ``12·N + 8·K`` over the cell's leaves
(``counts/chunk_topk.py``), at 3.35 TB/s, over its device time a step, in
%. Nothing where the trace holds no launch of it."""

from portbench.counts.chunk_topk import compress_bytes
from portbench.counts.peaks import HBM_BYTES_PER_S

KERNEL = "chunk_compress_feedback_kernel"


def read(run):
    ops = [o for o in run.trace.kernels() if KERNEL in o.name]
    if not ops:
        return None
    ratio = run.cell.mix["grace"]["compress_ratio"]
    bound_s = compress_bytes(run.leaf_sizes, ratio) / HBM_BYTES_PER_S
    kernel_s = sum(o.dur for o in ops) / 1e6 / run.trace.steps
    return 100.0 * bound_s / kernel_s
