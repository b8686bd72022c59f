"""The share of the traced train steps' span in which no operation ran on
the device (the union of the kernel, copy and set intervals of the
profiler's trace), in %.  The exchange's NCCL kernels count as idle
(``Trace.work_s``): they spin while their rank waits for the others.  On
a sharded cell, the mean over the ranks."""


def read(run):
    if run.entry != "train":
        return None
    tr = run.trace
    mine = 100.0 * (1.0 - tr.work_s / tr.window_s) if tr.window_s > 0 else None
    return run.rank_mean(mine)
