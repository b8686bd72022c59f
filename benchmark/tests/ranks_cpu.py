"""One rank of a sharded run on the CPU at the tiny size (gloo), for
``test_bench_sharded.py``: cell ``<cell>`` under mix ``<traffic>`` on
``<world>`` ranks:

    python ranks_cpu.py <cell> <traffic> <rank> <world> <port> <seed> [<fault>]

Rank 0 prints the result line."""

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
    program.build_bundle = _tiny_bundle
    cell = tiny_cell(name, traffic, world)
    ranks = runner.Mesh(rank, world, port, "cpu")
    with faults.planted(fault, cell.cfg):
        result = runner.run_cell(cell, seed, 0.5, False, "cpu", time.time(), ranks)
    dist.destroy_process_group()
    if result is not None:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
