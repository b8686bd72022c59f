"""The share of the traced train steps' span in which no operation ran on
the device (the union of the kernel, copy and set intervals of the
profiler's trace), in %."""


def read(run):
    if run.entry != "train" or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
