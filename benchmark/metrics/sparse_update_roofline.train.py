"""The lazy sparse-optimizer pass's share of its roofline in the train
step: K8 (``sparse_adam_group_kernel``) or K9
(``sparse_adagrad_group_kernel``); its least time from the live rows of
the traced steps' batches (``counts/<config>.py``, ``sparse_update``)
over its device time in the trace, in %.  On a sharded cell each rank's
pass updates its blocks of the tables for the ids of every rank: its
least time counts the live rows of the whole batch in its blocks of the
tables' storages (``peaks.table_shard``), its device time comes from its
own trace, and the metric is the mean over the ranks."""

KERNELS = ("sparse_adam_group_kernel", "sparse_adagrad_group_kernel")


def read(run):
    if run.entry != "train":
        return None
    match = lambda name: name in KERNELS  # noqa: E731
    return run.rank_mean(run.kernel_share("sparse_update", match, shard=run.world > 1))
