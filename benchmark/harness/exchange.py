"""The device time of the exchange between the ranks of a sharded cell,
read collective by collective from each rank's own device trace.

The exchange is every NCCL kernel the traced steps ran
(``trace.exchange_op``): the all-to-alls of the lookup's pull and of the
update's push, and the dense gradients' all-reduce.  Every rank issues
the same collectives in the same order, so the k-th NCCL kernel of one
rank's trace and the k-th of another's are one collective.  A
collective's kernel runs from its launch until the last rank has joined
it and the transfer is done, so the rank that joined last reads the
transfer alone, and every other rank reads the transfer plus its wait
for the last.  The transfer of a collective is then the least over the
ranks of its kernel's time, and a rank's wait is its NCCL time less the
sum of those least times.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .trace import exchange_op, short_name

_CACHE = "_exchange"


def nccl_kernels(trace) -> List[Tuple[str, float]]:
    """(short name, device µs) of each NCCL kernel of ``trace``, in the
    order they started."""
    return [(short_name(name), dur) for _, dur, name in trace.device if exchange_op(name)]


def read(run) -> Optional[Tuple[float, List[float], List[float]]]:
    """(the transfer's device ms a traced step, each rank's NCCL ms a
    traced step, each rank's traced step in ms), ranks in rank order;
    None where a rank's trace holds no NCCL kernel or the ranks' NCCL
    kernels do not pair up one to one by name.  Gathered once a run (a
    collective on every rank)."""
    if not hasattr(run, _CACHE):
        steps = max(1, len(run.traced_batches))
        per = run.gather((nccl_kernels(run.trace), 1e3 * run.trace.window_s / steps))
        kernels = [k for k, _ in per]
        names = [[name for name, _ in k] for k in kernels]
        out = None
        if kernels[0] and all(n == names[0] for n in names):
            transfer = sum(min(durs) for durs in zip(*[[d for _, d in k] for k in kernels]))
            out = (1e-3 * transfer / steps,
                   [1e-3 * sum(d for _, d in k) / steps for k in kernels],
                   [step for _, step in per])
        setattr(run, _CACHE, out)
    return getattr(run, _CACHE)
