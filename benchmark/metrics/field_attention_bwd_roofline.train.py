"""The field attention's backward (K5b, ``field_attention_bwd_kernel``)
share of its roofline in the train step: its least time at the traced
steps' batch (``counts/<config>.py``, ``field_attention_bwd``) over its
device time in the trace, in %.  On a sharded cell each rank's kernel
runs on the rank's own batch beside the exchange's NCCL kernels, and the
metric is the mean over the ranks."""


def read(run):
    if run.entry != "train":
        return None
    return run.rank_mean(run.kernel_share("field_attention_bwd",
                                          lambda name: name == "field_attention_bwd_kernel"))
