#!/usr/bin/env python3
"""Where the time of the port's predict step goes, on one CUDA card.

    python3 scripts/torch_profile_predict.py [--model autoint] [--batch 65536 256] [--steps 10]
    python3 scripts/torch_profile_predict.py --model staytime [--batch 16384 256]
    python3 scripts/torch_profile_predict.py --model ctr [--batch 32768 256] [--without-k6]
    python3 scripts/torch_profile_predict.py --model ctr212 [--batch 8192]
    python3 scripts/torch_profile_predict.py --model finish [--batch 32768 256]

For each batch size: builds the model's full-width bundle (autoint: 24
tables of 265,000 rows x 8; ctr: 24 tables of 265,000 x 48; multi_head: 40
tables of 265,000 x 8; staytime: 91 tables of 81,920 rows x 32 and 3
behaviour sequences of 50; ctr212: the 212-feature ctr shape,
``synthetic_ctr_config(num_slots=180, num_bias=32)`` over 32,768-id
buckets with one id per column; finish: 40 tables of 25,600 x 32; seeded
random weights, 5 ids per mean column elsewhere),
warms the predict step up, then
  - times ``steps`` calls on the host clock, ending in a synchronize;
  - traces the same number of calls with ``torch.profiler`` and sums the
    device time of every kernel: busy share = device time / wall time;
  - lists the kernels by device time (kernel names as the trace gives them)
    and each port kernel's device time a call (``port_kernel_us_per_call``).
Prints one JSON line per batch size, with the card's name and power limit,
and writes the tables to ``chiprun_out/profile_predict_<model>[_without_k6].txt``.

``--without-k6`` profiles the path that K6 replaces, as the yardstick for
it: the script runs the model's InteractingLayer through the layer's
transposed path (projections, K5f, LayerNorm).  The port itself has no
such option; the layer takes K6 wherever K6 applies.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_profile_common import card as card_name  # noqa: E402
from torch_profile_common import device_kernels, device_us, port_kernel_us  # noqa: E402


DEFAULT_BATCHES = {"autoint": [65536, 256], "ctr": [32768, 256], "ctr212": [8192],
                   "multi_head": [32768, 256], "staytime": [16384, 256],
                   "finish": [32768, 256]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="autoint", choices=sorted(DEFAULT_BATCHES))
    ap.add_argument("--batch", type=int, nargs="+", default=None)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--without-k6", action="store_true",
                    help="profile the InteractingLayer's transposed path instead of K6")
    args = ap.parse_args(argv)
    if args.without_k6 and args.model in ("staytime", "finish"):
        ap.error(f"--without-k6: {args.model} has no InteractingLayer")
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from recommendsystem_tpu_torch.core.config import synthetic_ctr_config
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.train import create_train_state, make_predict_step

    card = card_name()
    print(card, flush=True)
    batches = args.batch or DEFAULT_BATCHES[args.model]
    if args.model == "ctr212":
        bundle = create_model("ctr", cfg=synthetic_ctr_config(num_slots=180, num_bias=32),
                              bucket_size=32768, device="cuda")
        ids_per_feature = {}
    else:
        bundle = create_model(args.model, device="cuda")
        ids_per_feature = 5
    suffix = ""
    if args.without_k6:
        layer = bundle.module.interacting
        layer.forward = layer.forward_transposed
        suffix = "_without_k6"
    state = create_train_state(bundle, seed=0)
    step = make_predict_step(bundle)
    os.makedirs("chiprun_out", exist_ok=True)
    tables = []
    for b in batches:
        batch, _, _, _ = synthetic_batch(bundle, b, seed=1, ids_per_feature=ids_per_feature)
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
        kernels = device_kernels(prof)
        busy_us = sum(device_us(e) for e in kernels) / args.steps
        top = [{"name": e.key[:90], "calls_per_step": e.count // args.steps,
                "us_per_step": device_us(e) / args.steps} for e in kernels[:12]]
        n_kernels = sum(e.count for e in kernels) // args.steps
        row = {"model": args.model + suffix, "batch": b, "ms_per_call": wall * 1e3,
               "port_kernel_us_per_call": port_kernel_us(kernels, args.steps),
               "examples_per_s": b / wall, "traced_ms_per_call": traced_wall * 1e3,
               "device_busy_ms_per_call": busy_us / 1e3,
               "device_busy_share": busy_us / 1e3 / (traced_wall * 1e3),
               "device_kernels_per_call": n_kernels,
               "port_kernel_launches_per_call": counts, "card": card}
        print(json.dumps(row), flush=True)
        tables.append(f"## {args.model}{suffix} batch {b} ({card})\n{json.dumps(row)}\n"
                      + "\n".join(json.dumps(t) for t in top) + "\n")
    with open(os.path.join("chiprun_out", f"profile_predict_{args.model}{suffix}.txt"),
              "w") as fh:
        fh.write("\n".join(tables))
    print("\n".join(tables), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
