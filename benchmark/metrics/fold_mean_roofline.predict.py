"""The grouped mean fold's (K1, ``fold_mean_group_kernel``) share of its
roofline in the predict call: its least time from the traced calls'
batches (``counts/<config>.py``, ``fold_mean``) over its device time in
the trace, in %."""


def read(run):
    if run.entry != "predict":
        return None
    return run.kernel_share("fold_mean", lambda name: name == "fold_mean_group_kernel")
