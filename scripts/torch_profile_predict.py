#!/usr/bin/env python3
"""Where the time of the port's autoint predict step goes, on one CUDA card.

    python3 scripts/torch_profile_predict.py [--batch 65536 256] [--steps 10]

For each batch size: builds the full-width autoint bundle (24 tables of
265,000 rows x 8, seeded random weights), warms the predict step up, then
  - times ``steps`` calls on the host clock, ending in a synchronize;
  - traces the same number of calls with ``torch.profiler`` and sums the
    device time of every kernel: busy share = device time / wall time;
  - lists the kernels by device time (kernel names as the trace gives them).
Prints one JSON line per batch size, with the card's name and power limit,
and writes the tables to ``chiprun_out/profile_predict.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[65536, 256])
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.train import create_train_state, make_predict_step

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    bundle = create_model("autoint", device="cuda")
    state = create_train_state(bundle, seed=0)
    step = make_predict_step(bundle)
    os.makedirs("chiprun_out", exist_ok=True)
    tables = []
    for b in args.batch:
        batch, _, _, _ = synthetic_batch(bundle, b, seed=1)
        for _ in range(3):
            step(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step(state, batch)
            torch.cuda.synchronize()
            traced_wall = (time.perf_counter() - t0) / args.steps
        counts = {k: v // args.steps for k, v in launch_counts().items()}
        kernels = [e for e in prof.key_averages()
                   if _device_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(_device_us(e) for e in kernels) / args.steps
        kernels.sort(key=_device_us, reverse=True)
        top = [{"name": e.key[:90], "calls_per_step": e.count // args.steps,
                "us_per_step": _device_us(e) / args.steps} for e in kernels[:12]]
        n_kernels = sum(e.count for e in kernels) // args.steps
        row = {"batch": b, "ms_per_call": wall * 1e3,
               "examples_per_s": b / wall, "traced_ms_per_call": traced_wall * 1e3,
               "device_busy_ms_per_call": busy_us / 1e3,
               "device_busy_share": busy_us / 1e3 / (traced_wall * 1e3),
               "device_kernels_per_call": n_kernels,
               "port_kernel_launches_per_call": counts, "card": card}
        print(json.dumps(row), flush=True)
        tables.append(f"## batch {b} ({card})\n{json.dumps(row)}\n"
                      + "\n".join(json.dumps(t) for t in top) + "\n")
    with open(os.path.join("chiprun_out", "profile_predict.txt"), "w") as fh:
        fh.write("\n".join(tables))
    print("\n".join(tables), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
