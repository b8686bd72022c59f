"""The DIN pool's (K7 gathering its facts, ``din_pool_gather_kernel``)
share of its roofline in the predict call, over its calls (one a
behaviour sequence): its least time from the traced calls' batches
(``counts/<config>.py``, ``din_pool``) over its device time in the trace,
in %."""


def read(run):
    if run.entry != "predict":
        return None
    return run.kernel_share("din_pool", lambda name: name == "din_pool_gather_kernel")
