"""The low-rank cross layer's elementwise backward (K10,
``dcn_cross_bwd_kernel``, a kernel whose name starts ``dcn_cross``) share
of its roofline in the train step, over its calls (one a cross layer): its
least time at the traced steps' batch (``counts/<config>.py``,
``dcn_cross``) over its device time in the trace, in %.  None where the
trace holds no such kernel (a program without K10) or the configuration
counts none."""


def read(run):
    if run.entry != "train":
        return None
    return run.rank_mean(run.kernel_share("dcn_cross",
                                          lambda name: name.startswith("dcn_cross")))
