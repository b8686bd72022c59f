"""The field attention's backward (K5b, ``field_attention_bwd_kernel``)
share of its roofline in the train step: its least time at the traced
steps' batch (``counts/<config>.py``, ``field_attention_bwd``) over its
device time in the trace, in %."""


def read(run):
    if run.entry != "train":
        return None
    return run.kernel_share("field_attention_bwd",
                            lambda name: name == "field_attention_bwd_kernel")
