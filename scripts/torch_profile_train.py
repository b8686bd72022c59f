#!/usr/bin/env python3
"""Where the time of the port's packed train step goes, on one CUDA card.

    python3 scripts/torch_profile_train.py [--model autoint] [--batch B] [--ids 5 1] [--steps 8]

``--model``: autoint (B = 65536, 5 and 1 ids), ctr (B = 32768), ctr212
(the 212-feature ctr shape, ``synthetic_ctr_config(num_slots=180,
num_bias=32)`` over 32,768-id buckets, B = 8192, one id a column),
multi_head (B = 32768), finish (B = 32768), rough_rank (B = 32768, 5
and 1 ids, the dense flag drawn with the batch) or staytime (the default
``StaytimeConfig``, B = 16384, 5 and 1 ids).  For each ids-per-feature
width: builds the full-width bundle (attention dropout 0.2 where the model
has it, seeded random weights), warms the packed train step up, then
  - times ``steps`` steps on the host clock in 3 windows, each ending in a
    synchronize and a host fetch of the last loss (ms per step and
    examples/s as the median window);
  - traces ``steps`` more with ``torch.profiler`` and sums the device time
    of every kernel: busy share = device time / wall time of the traced
    window;
  - lists the kernels by device time, each port kernel's device time a
    step (``port_kernel_us_per_step``), and the port kernels' launches per
    step.
For staytime the row also gives the device time of the DIN pools'
backward (``din_backward_us_per_step``): the three pools of a step at its
shapes (facts (B, 50, 16) from the step's batch), each backward through
``DinPoolFunction``, which recomputes through the plain version, between
CUDA events (launch gaps included), 5 calls after one warm-up.
Prints one JSON line per width, with the card's name and power limit, and
writes the tables to ``chiprun_out/profile_train_<model>.txt``.

``--penalty`` (ctr, ctr212, multi_head, finish) then measures what the L1L2
kernel penalty costs: the step with it and the same step built without it
(``regularized_kernels`` emptied), timed in turns, 3 windows each; and the
penalty alone, forward and backward from the step's params, as the port
computes it (one concatenation a coefficient pair) and as it was first
written (the terms of each regularized Dense apart): device kernels a call
from a trace, host µs a call (20 calls, then a synchronize).
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


# model -> (batch, ids per feature)
DEFAULTS = {"autoint": (65536, [5, 1]), "ctr": (32768, [5]), "ctr212": (8192, [1]),
            "multi_head": (32768, [5]), "finish": (32768, [5]), "rough_rank": (32768, [5, 1]),
            "staytime": (16384, [5, 1])}


def din_backward_us(bundle, state, batch) -> float:
    """Device µs of the backward of a staytime step's three DIN pools (see
    the module's docstring)."""
    from recommendsystem_tpu_torch.embedding import packed
    from recommendsystem_tpu_torch.kernels.din import din_pool
    from recommendsystem_tpu_torch.models.staytime import GENERAL

    eng, cfg = bundle.embedding, bundle.config
    with torch.no_grad():
        embs = packed.lookup_packed(eng, state.tables, batch)
    calls = []
    for s, q in cfg.seq_query:
        emb, mask = embs[f"seq_{s}"]
        facts = emb[:, :, :GENERAL].detach().requires_grad_()
        query = embs[q][:, :GENERAL].detach().requires_grad_()
        w = {n: state.params[f"din_{s}.{n}"].detach().requires_grad_()
             for n in ("w1", "b1", "w2", "b2")}
        out = din_pool(query, facts, mask.float(), w["w1"], w["b1"], w["w2"], w["b2"])
        calls.append((out, [query, facts, *w.values()]))
    grads = [torch.randn_like(out) for out, _ in calls]

    def backward():
        for (out, inputs), g in zip(calls, grads):
            torch.autograd.grad(out, inputs, g, retain_graph=True)

    backward()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        backward()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 5 * 1e3


def _per_layer_penalty(groups, params):
    """The penalty with the terms of each regularized Dense apart."""
    terms = []
    for (l1, l2), names in groups.items():
        for n in names:
            k = params[n]
            if l1:
                terms.append(l1 * torch.where(k >= 0, k, -k).sum())
            if l2:
                terms.append(l2 * (k * k).sum())
    return sum(terms[1:], terms[0])


def penalty_cost(bundle, step, state, data, steps: int) -> dict:
    """What the L1L2 penalty costs a step (see the module's docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from recommendsystem_tpu_torch.nn import kernel_penalty, regularized_kernels
    from recommendsystem_tpu_torch.train import make_train_step
    from recommendsystem_tpu_torch.train import step as step_mod

    groups = regularized_kernels(bundle.module)
    step_mod.regularized_kernels = lambda module: {}
    try:
        bare = make_train_step(bundle)
    finally:
        step_mod.regularized_kernels = regularized_kernels
    batch, labels, weight, dense = data
    seed = 100

    def window(fn):
        nonlocal state, seed
        t0 = time.perf_counter()
        for _ in range(steps):
            state, info = fn(state, batch, labels, weight, dense, seed)
            seed += 1
        float(info["loss"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    window(bare)
    ms = {"with": [], "without": []}
    for _ in range(3):
        ms["with"].append(window(step))
        ms["without"].append(window(bare))
    out = {"regularized_kernels": sum(len(v) for v in groups.values()),
           "coefficient_pairs": len(groups),
           "step_ms": {k: statistics.median(v) for k, v in ms.items()}, "window_ms": ms}
    keys = [n for names in groups.values() for n in names]
    for label, fn in (("grouped", kernel_penalty), ("per_layer", _per_layer_penalty)):
        params = {k: state.params[k].detach().requires_grad_() for k in keys}

        def call():
            reg = fn(groups, params)
            return torch.autograd.grad(reg, list(params.values()))

        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        torch.cuda.synchronize()
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        out[label] = {"kernels_per_call": sum(e.count for e in kernels) / 5,
                      "device_us_per_call": sum(device_us(e) for e in kernels) / 5,
                      "host_us_per_call": host_us}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="autoint", choices=sorted(DEFAULTS))
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--ids", type=int, nargs="+", default=None)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--penalty", action="store_true")
    args = ap.parse_args(argv)
    args.batch = args.batch or DEFAULTS[args.model][0]
    args.ids = args.ids or DEFAULTS[args.model][1]
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from recommendsystem_tpu_torch.core.config import synthetic_ctr_config
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.train import create_train_state, make_train_step

    card = card_name()
    print(card, flush=True)
    if args.model == "ctr212":
        bundle = create_model("ctr", cfg=synthetic_ctr_config(num_slots=180, num_bias=32),
                              bucket_size=32768, device="cuda")
    else:
        bundle = create_model(args.model, device="cuda")
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
        row = {"model": args.model, "batch": args.batch, "ids_per_feature": ipf,
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
        if args.model == "staytime":
            row["din_backward_us_per_step"] = din_backward_us(bundle, state, batch)
        print(json.dumps(row), flush=True)
        tables.append(f"## {args.model}, batch {args.batch}, {ipf} ids per feature ({card})\n"
                      f"{json.dumps(row)}\n" + "\n".join(json.dumps(t) for t in top)
                      + "\n")
        if args.penalty:
            row = penalty_cost(bundle, step, state, (batch, labels, weight, dense), args.steps)
            row.update({"model": args.model, "batch": args.batch, "ids_per_feature": ipf,
                        "card": card})
            print(json.dumps(row), flush=True)
            tables.append(f"## the L1L2 penalty\n{json.dumps(row)}\n")
    with open(os.path.join("chiprun_out", f"profile_train_{args.model}.txt"), "w") as fh:
        fh.write("\n".join(tables))
    print("\n".join(tables), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
