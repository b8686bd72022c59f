"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for (``BENCHMARK.json``: ``chips``).  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, ``breakdown`` with ``--trace 1``, and ``checks``: each number
the check compared, with its limit, which are also the last lines of
standard error).  Exits 2 without a result where CUDA is missing or there
are fewer cards than the cell asks for, and 3 where a module of JAX or of
the JAX package was loaded.

A cell on more than one card starts one process a card (``--rank``),
which meet on a free localhost port; rank 0 prints the result, and this
process passes it on.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--start-epoch", type=float, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _print_result(result: dict) -> None:
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def _launch(args, chips: int, start_epoch: float) -> int:
    """One process a card; rank 0's result line passed on."""
    port = _free_port()
    procs = []
    for rank in range(chips):
        cmd = [sys.executable, os.path.abspath(__file__), "--workload", args.workload,
               "--seed", str(args.seed), "--seconds", str(args.seconds),
               "--trace", str(args.trace), "--rank", str(rank), "--port", str(port),
               "--start-epoch", repr(start_epoch)]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE if rank == 0 else
                                      subprocess.DEVNULL, text=True))
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            break
        if any(c for c in codes if c is not None):     # a rank failed: stop the others
            for p in procs:
                if p.poll() is None:
                    p.kill()
            codes = [p.wait() for p in procs]
            break
        time.sleep(0.2)
    out = procs[0].stdout.read()
    procs[0].stdout.close()
    if any(codes):
        print(f"ranks exited with {codes}", file=sys.stderr)
        return next(c for c in codes if c) or 1
    from harness.runner import forbidden_modules
    found = forbidden_modules()
    if found:
        print(f"JAX modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    _print_result(json.loads(out.strip().splitlines()[-1]))
    return 0


def main(argv=None) -> int:
    args = _args(argv)
    from harness.runner import process_start_epoch
    start_epoch = args.start_epoch if args.start_epoch is not None else process_start_epoch()
    import torch

    from harness import cells
    torch.set_num_threads(1)           # one busy host thread: steadier runs on a shared host
    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if cell.chips > 1 and args.rank is None:
        return _launch(args, cell.chips, start_epoch)
    from harness import runner
    ranks = None
    if cell.chips > 1:
        ranks = runner.Mesh(args.rank, cell.chips, args.port, "cuda")
    device = ranks.mesh.device if ranks else torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                             start_epoch, ranks)
    found = runner.forbidden_modules()
    if ranks is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    if found:
        print(f"JAX modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    if result is not None:
        if ranks is not None:
            print(json.dumps(result), flush=True)
        else:
            _print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
