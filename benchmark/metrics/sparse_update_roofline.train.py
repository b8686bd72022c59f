"""The lazy sparse-optimizer pass's share of its roofline in the train
step: K8 (``sparse_adam_group_kernel``) or K9
(``sparse_adagrad_group_kernel``); its least time from the live rows of
the traced steps' batches (``counts/<config>.py``, ``sparse_update``)
over its device time in the trace, in %."""

KERNELS = ("sparse_adam_group_kernel", "sparse_adagrad_group_kernel")


def read(run):
    if run.entry != "train" or run.world != 1:
        return None
    return run.kernel_share("sparse_update", lambda name: name in KERNELS)
