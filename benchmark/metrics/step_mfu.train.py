"""The train step's share of the chip's peak: its least time on one chip
(the larger of its FLOPs at 67 TFLOP/s in float32 and its compulsory bytes
at 3.35 TB/s, ``counts/<config>.py``, averaged over the traced steps'
batches, a rank's own on a sharded cell) over the measured time a step of the
untraced window, in %."""


def read(run):
    if run.entry != "train" or run.step_s <= 0:
        return None
    return 100.0 * run.step_least_s() / run.step_s
