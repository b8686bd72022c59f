#!/usr/bin/env python3
"""How close two train steps on the card come to the same two on the CPU.

    python3 scripts/torch_train_margins.py [--batch 64 256] [--seeds 31 32 33]

For autoint, ctr, the 212-feature ctr (``synthetic_ctr_config(num_slots=180,
num_bias=32)``, one id a column), multi_head, finish, rough_rank and
staytime (5 ids and 1 for the last two), at the smaller buckets of
``chip_smoke.py``'s checks and each batch size and batch seed given:
``chip_smoke.witness`` (two steps from one seeded state, same step seeds
and dropout), one JSON line a draw with each quantity's margin against its
``TRAIN_*`` tolerance (largest |card - cpu| / (atol + rtol |cpu|); within
it is at most 1), the count of elements past it, and for a draw past it
the entries that a kink on their path (for a dense entry: the CPU step
with the card's kinks gives the card's gradient) or a gradient within
rounding of 0 explains and those that nothing does.  A ReLU tower compared across two float32
implementations meets kinks: a unit whose input is within rounding of 0 on
one side takes another branch on the other, and its sample's gradients
then differ by far more than rounding.  The draws show how often, and
``chip_smoke.py``'s check fails a draw only where something past the
tolerance stays unexplained.

    python3 scripts/torch_train_margins.py --witness ctr:128:33 [MODEL:B:SEED ...]

prints the whole witness of the given draws (the flips, their samples and
both values, the explanations), one JSON line a draw, and writes them to
``chiprun_out/train_witness.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _runs():
    from recommendsystem_tpu_torch.core.config import synthetic_ctr_config

    from recommendsystem_tpu_torch.models.staytime import StaytimeConfig

    ctr212 = {"cfg": synthetic_ctr_config(num_slots=180, num_bias=32)}
    staytime = {"cfg": StaytimeConfig(bucket_size=2048)}
    # label -> (model, factory kwargs with chip_smoke's check bucket, ids a column)
    return {"autoint": ("autoint", {}, 5), "ctr": ("ctr", {"bucket_size": 16384}, 5),
            "ctr212": ("ctr", {**ctr212, "bucket_size": 4096}, 1),
            "multi_head": ("multi_head", {"bucket_size": 16384}, 5),
            "finish": ("finish", {"bucket_size": 8192}, 5),
            "rough_rank": ("rough_rank", {"bucket_size": 2048}, 5),
            "rough_rank1": ("rough_rank", {"bucket_size": 2048}, 1),
            "staytime": ("staytime", staytime, 5), "staytime1": ("staytime", staytime, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--seeds", type=int, nargs="+", default=[31, 32, 33])
    ap.add_argument("--witness", nargs="+", default=None, metavar="MODEL:B:SEED")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from recommendsystem_tpu_torch.models import create_model

    card = chip_smoke.subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    runs = _runs()
    if args.witness:
        found = []
        for draw in args.witness:
            label, b, seed = draw.split(":")
            name, kw, ipf = runs[label]
            w = chip_smoke.witness(create_model(name, device="cuda", **kw),
                                   create_model(name, device="cpu", **kw), int(b), ipf,
                                   int(seed))
            w.update({"model": label, "batch": int(b), "seed": int(seed), "card": card})
            found.append(w)
            print(json.dumps(w), flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "train_witness.json"), "w") as fh:
            json.dump(found, fh)
        return 0
    for label, (name, kw, ipf) in runs.items():
        bundle = create_model(name, device="cuda", **kw)
        cpu = create_model(name, device="cpu", **kw)
        for b in args.batch:
            for seed in args.seeds:
                t0 = time.perf_counter()
                w = chip_smoke.witness(bundle, cpu, b, ipf, seed)
                m = w["margins"]
                print(json.dumps({"model": label, "batch": b, "seed": seed,
                                  "margin": {n: v["margin"] for n, v in m.items()},
                                  "past": {n: v["past"] for n, v in m.items() if v["past"]},
                                  "explained": w["explained"],
                                  "unexplained": len(w["unexplained"]),
                                  "first_unexplained": w["unexplained"][:3],
                                  "details": w["details"][:3],
                                  "s": time.perf_counter() - t0, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
