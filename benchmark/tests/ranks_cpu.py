"""One rank of a sharded run on the CPU at the tiny size (gloo), for
``test_bench_sharded.py``: cell ``<cell>`` under mix ``<traffic>`` on
``<world>`` ranks:

    python ranks_cpu.py <cell> <traffic> <rank> <world> <port> <seed> [<fault> | traced]

Rank 0 prints the result line.  ``traced`` makes a ``--trace 1`` run of
the traced steps over pool batches 0 and 1, whose device trace, as the
CPU launches no kernel, holds in its place stand-in kernels
(``stand_in_events``): 1 s of K8, 1 ms of K5b, and a step's three
collectives, each of which rank r runs for (1 + (r + k) % world) ms
(``NCCL_S``), k its place in the trace, so the rank that joins last
changes from one collective to the next."""

from __future__ import annotations

import json
import sys
import time

import conftest  # noqa: F401  (the import path)
from conftest import _tiny_bundle, tiny_cell


def main(argv) -> int:
    import torch.distributed as dist

    import faults
    from harness import program, runner

    name, traffic, (rank, world, port, seed) = argv[0], argv[1], map(int, argv[2:6])
    fault = argv[6] if len(argv) > 6 else "sound"
    traced = fault == "traced"
    program.build_bundle = _tiny_bundle
    cell = tiny_cell(name, traffic, world)
    ranks = runner.Mesh(rank, world, port, "cpu")
    if traced:
        fault = "sound"
        _stand_in_trace(rank, world)
    with faults.planted(fault, cell.cfg):
        result = runner.run_cell(cell, seed, 0.5, traced, "cpu", time.time(), ranks)
    dist.destroy_process_group()
    if result is not None:
        print(json.dumps(result), flush=True)
    return 0


ONE_CARD_K8_S = 1.0
K5B_S = 1e-3
NCCL_S = 1e-3
COLLECTIVES = ("ncclDevKernel_SendRecv", "ncclDevKernel_SendRecv",
               "ncclDevKernel_AllReduce_Sum_f32_RING_LL")


def stand_in_events(rank: int, world: int, t0: float, steps: int = 2):
    """(ts, dur, name) in µs of the stand-in kernels of ``steps`` traced
    steps from ``t0``, one after another."""
    out, t = [], t0
    for step in range(steps):
        kernels = [("sparse_adam_group_kernel", 1e6 * ONE_CARD_K8_S / steps),
                   ("field_attention_bwd_kernel", 1e6 * K5B_S / steps)]
        for i, name in enumerate(COLLECTIVES):
            k = step * len(COLLECTIVES) + i
            kernels.append((f"{name}(ncclDevKernelArgsStorage<4096ul>)",
                            1e6 * NCCL_S * (1 + (rank + k) % world)))
        for name, dur in kernels:
            out.append((t, dur, name))
            t += dur
    return out


def _stand_in_trace(rank: int, world: int) -> None:
    """The device trace that a card would give, and the traced steps on
    pool batches 0 and 1 (the window's length moves them else)."""
    from harness import runner

    traced = runner.traced

    def with_kernels(work, device, host):
        tr = traced(work, device, host)
        tr.device = sorted(tr.device + stand_in_events(rank, world, tr.t0))
        return tr

    traced_steps = runner.Session.traced_steps

    def from_batch_0(self):
        self.next_item = 0
        return traced_steps(self)

    runner.traced = with_kernels
    runner.Session.traced_steps = from_batch_0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
