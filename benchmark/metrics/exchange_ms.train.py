"""The exchange's device ms a train step on a sharded cell: over the
collectives of the traced steps (the all-to-alls of the pull and the
push, the dense all-reduce), the sum of each collective's least NCCL
kernel time over the ranks, a step (``harness/exchange.py``).  The rank
that joins a collective last reads its transfer alone, so the ranks'
waits on each other stay out.  Left out on one card, and where the
ranks' NCCL kernels do not pair up."""

from harness import exchange


def read(run):
    if run.entry != "train" or run.world == 1:
        return None
    got = exchange.read(run)
    return None if got is None or got[0] <= 0 else got[0]
