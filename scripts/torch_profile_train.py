#!/usr/bin/env python3
"""Where the time of the port's autoint train step goes, on one CUDA card.

    python3 scripts/torch_profile_train.py [--batch 65536] [--ids 5 1] [--steps 8]

For each ids-per-feature width: builds the full-width autoint bundle (24
tables of 265,000 rows x 8, attention dropout 0.2, seeded random weights),
warms the packed train step up, then
  - times ``steps`` steps on the host clock in 3 windows, each ending in a
    synchronize and a host fetch of the last loss (ms per step and
    examples/s as the median window);
  - traces ``steps`` more with ``torch.profiler`` and sums the device time
    of every kernel: busy share = device time / wall time of the traced
    window;
  - lists the kernels by device time, each port kernel's device time a
    step (``port_kernel_us_per_step``), and the port kernels' launches per
    step.
Prints one JSON line per width, with the card's name and power limit, and
writes the tables to ``chiprun_out/profile_train.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_profile_common import card as card_name  # noqa: E402
from torch_profile_common import device_kernels, device_us, port_kernel_us  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--ids", type=int, nargs="+", default=[5, 1])
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.train import create_train_state, make_train_step

    card = card_name()
    print(card, flush=True)
    bundle = create_model("autoint", device="cuda")
    step = make_train_step(bundle)
    os.makedirs("chiprun_out", exist_ok=True)
    tables = []
    for ipf in args.ids:
        state = create_train_state(bundle, seed=0)
        batch, dense, labels, weight = synthetic_batch(bundle, args.batch, seed=1,
                                                       ids_per_feature=ipf)
        seed = 0

        def run(n):
            nonlocal state, seed
            for _ in range(n):
                state, info = step(state, batch, labels, weight, dense, seed)
                seed += 1
            return float(info["loss"])           # host fetch: waits for the step

        run(3)
        torch.cuda.synchronize()
        windows = []
        for _ in range(3):
            t0 = time.perf_counter()
            loss = run(args.steps)
            torch.cuda.synchronize()
            windows.append((time.perf_counter() - t0) / args.steps)
        wall = statistics.median(windows)
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(args.steps)
            torch.cuda.synchronize()
            traced_wall = (time.perf_counter() - t0) / args.steps
        counts = {k: v / args.steps for k, v in launch_counts().items()}
        kernels = device_kernels(prof)
        busy_us = sum(device_us(e) for e in kernels) / args.steps
        top = [{"name": e.key[:90], "calls_per_step": e.count / args.steps,
                "us_per_step": device_us(e) / args.steps} for e in kernels[:16]]
        row = {"batch": args.batch, "ids_per_feature": ipf,
               "port_kernel_us_per_step": port_kernel_us(kernels, args.steps),
               "ms_per_step": wall * 1e3, "examples_per_s": args.batch / wall,
               "window_ms": [w * 1e3 for w in windows], "last_loss": loss,
               "traced_ms_per_step": traced_wall * 1e3,
               "device_busy_ms_per_step": busy_us / 1e3,
               "device_busy_share": busy_us / 1e3 / (traced_wall * 1e3),
               "device_kernels_per_step": sum(e.count for e in kernels) / args.steps,
               "port_kernel_launches_per_step": counts,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "card": card}
        print(json.dumps(row), flush=True)
        tables.append(f"## batch {args.batch}, {ipf} ids per feature ({card})\n"
                      f"{json.dumps(row)}\n" + "\n".join(json.dumps(t) for t in top)
                      + "\n")
    with open(os.path.join("chiprun_out", "profile_train.txt"), "w") as fh:
        fh.write("\n".join(tables))
    print("\n".join(tables), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
