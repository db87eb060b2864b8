"""``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()``: the largest over the ranks, in GiB."""


def read(run):
    return run.window_peak_bytes / 2 ** 30
