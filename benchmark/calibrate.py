"""The readings that the limits of ``correct`` are set from, on the chip at
the cell's own sizes, all in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--fault-seeds 7,8,9]

For each seed of ``--seeds``, a sound run: set-up, the check steps (or,
for a scoring cell, a short window of calls) through the program, then the
numbers against the reference.  For each of ``--control-seeds``, the
control: the reference computed in TF32 in the program's place, against
the float32 reference.  For each of ``--fault-seeds``, every fault the
cell can have, planted in the program (``faults.py``).  One JSON line a
reading; the last line holds, for each number, the largest sound reading
and the smallest reading of the control and of each fault.  The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
for path in (BENCH, os.path.dirname(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


def readings(cell, seed: int, device, kind: str = "sound", seconds: float = 2.0,
             ranks=None):
    """The numbers of one run of ``kind``: "sound", "control" or a fault of
    ``faults.faults_of`` (None on a rank other than 0)."""
    import torch

    import faults
    from harness import runner

    s = runner.Session(cell, seed, seconds, device, time.time(), ranks)
    with faults.planted(kind, cell.cfg):
        s.setup()
        if cell.traffic["entry"] == "train":
            prog = s.check_steps() if kind != "control" else None
            s.next_item = cell.traffic["check_steps"]
            s.sample = []
        else:
            prog = None
            s.warm()
            s.window()
    s.free_program()
    if ranks is not None:
        ranks.barrier()
        if ranks.rank != 0:
            return None
    numbers = s.reference_numbers(prog, tf32=(kind == "control"))
    diagnostics = getattr(s, "diagnostics", None)
    if diagnostics:
        print(json.dumps({"kind": kind, "seed": seed, "diagnostics": diagnostics}),
              file=sys.stderr)
    del s
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    import faults
    from harness import cells

    cell = cells.load(args.workload)
    ranks = None
    if cell.chips > 1:
        if args.rank is None:
            return _launch(argv if argv is not None else sys.argv[1:], cell.chips)
        import torch

        from harness import runner
        ranks = runner.Mesh(args.rank, cell.chips, args.port, args.device)
        torch.cuda.set_device(ranks.mesh.device)
    ints = lambda text: [int(x) for x in text.split(",") if x]  # noqa: E731
    summary: dict = {}
    plan = ([("sound", s) for s in ints(args.seeds)]
            + [("control", s) for s in ints(args.control_seeds)]
            + [(f, s) for s in ints(args.fault_seeds)
               for f in faults.faults_of(cell, ranks is not None)])
    for kind, seed in plan:
        t0 = time.time()
        numbers = readings(cell, seed, ranks.mesh.device if ranks else args.device, kind,
                           ranks=ranks)
        if numbers is None:
            continue
        print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers,
                          "seconds": time.time() - t0}), flush=True)
        for name, value in numbers.items():
            slot = summary.setdefault(name, {})
            if kind == "sound":
                slot["lower"] = max(slot.get("lower", 0.0), value)
            else:
                slot[kind] = min(slot.get(kind, float("inf")), value)
    if ranks is None or ranks.rank == 0:
        print(json.dumps({"summary": summary}), flush=True)
    return 0


def _launch(argv, chips: int) -> int:
    """One process a card, meeting on a free localhost port; rank 0's
    lines are this process's."""
    import subprocess

    from run import _free_port
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *argv,
                               "--rank", str(r), "--port", str(port)],
                              stdout=None if r == 0 else subprocess.DEVNULL)
             for r in range(chips)]
    codes = [p.wait() for p in procs]
    return next((c for c in codes if c), 0)


if __name__ == "__main__":
    sys.exit(main())
