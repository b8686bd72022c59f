"""The predict call's share of the chip's peak: its least time (the
larger of its FLOPs at 67 TFLOP/s in float32 and its compulsory bytes at
3.35 TB/s, ``counts/<config>.py``, averaged over the traced calls'
batches) over the measured time a call of the untraced window, in %."""


def read(run):
    if run.entry != "predict" or run.step_s <= 0:
        return None
    return 100.0 * run.step_least_s() / run.step_s
