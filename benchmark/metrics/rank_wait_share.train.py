"""The share of a sharded train step that the ranks spend waiting on each
other inside the exchange: the mean over the ranks of the rank's NCCL
kernel ms a traced step less the transfer's (``exchange_ms.train``,
``harness/exchange.py``), over the rank's traced step (its device
trace's window over the traced steps), in %.  Both come from the traced
steps, which the profiler slows: over the untraced step the share could
pass 100.  Left out on one card, and where the ranks' NCCL kernels do not
pair up."""

from harness import exchange


def read(run):
    if run.entry != "train" or run.world == 1:
        return None
    got = exchange.read(run)
    if got is None or got[0] <= 0 or min(got[2]) <= 0:
        return None
    transfer, nccl, step = got
    return 100.0 * sum((x - transfer) / s for x, s in zip(nccl, step)) / len(nccl)
