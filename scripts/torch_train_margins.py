#!/usr/bin/env python3
"""How close two train steps on the card come to the same two on the CPU.

    python3 scripts/torch_train_margins.py [--batch 64 256] [--seeds 31 32 33]

For autoint, ctr, the 212-feature ctr (``synthetic_ctr_config(num_slots=180,
num_bias=32)``, one id a column), multi_head and finish, at the smaller
buckets of ``chip_smoke.py``'s checks and each batch size and batch seed
given: ``chip_smoke.card_vs_cpu_margins`` (two steps from one seeded state,
same step seeds and dropout), one JSON line a draw with each quantity's
margin against its ``TRAIN_*`` tolerance (largest |card - cpu| / (atol +
rtol |cpu|); within it is at most 1) and the count of elements past it.
A ReLU tower compared across two float32 implementations meets kinks: a
unit whose input is within rounding of 0 on one side takes another branch
on the other, and its sample's gradients then differ by far more than
rounding.  The draws show how often.

    python3 scripts/torch_train_margins.py --witness ctr:128:33 [MODEL:B:SEED ...]

runs the given draws again and looks for those kinks: it records the input
of every ReLU in both steps on the card and on the CPU, lists each element
whose sign differs between them (its step, call, shape, sample and both
values), and maps every table row with an entry past its tolerance to the
samples of the batch that look it up.  A draw whose past rows all belong to
samples with a ReLU input on either side of 0 (by about a float32 rounding
of the call's scale) fails by kinks; past rows of other samples, or no
flip at all, would point at a fault.  One JSON line a draw; the flips and
the row map go to ``chiprun_out/train_witness.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.overrides import TorchFunctionMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _ReluInputs(TorchFunctionMode):
    """Records a host copy of the input of every ``torch.relu`` call, by
    device type."""

    def __init__(self):
        super().__init__()
        self.seen = {"cuda": [], "cpu": []}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.relu, torch.nn.functional.relu, torch.Tensor.relu):
            self.seen[args[0].device.type].append(args[0].detach().to("cpu", copy=True))
        return func(*args, **(kwargs or {}))


def _sample_of(shape, index, b):
    """The sample an element of a ReLU input belongs to: the batch is the
    leading dim of the towers' (B, ...) and the last, batch-minor, of the
    InteractingLayer's (U, F B) and (U, F, B)."""
    return int(index[0]) if shape[0] == b else int(index[-1]) % b


def witness(chip_smoke, bundle, cpu, b, ipf, seed):
    """One draw of ``two_train_steps`` with every ReLU input recorded: the
    flips (elements on either side of 0 between the card and the CPU) and,
    per table quantity, the rows past the tolerance and the samples that
    look them up."""
    from recommendsystem_tpu_torch.data import synthetic_batch

    grads = {"card": [], "cpu": []}
    for side, bnd in (("card", bundle), ("cpu", cpu)):
        opt = bnd.dense_optimizer
        update = opt.update_

        def record(params, g, state, side=side, update=update):
            grads[side].append({k: v.detach().cpu() for k, v in g.items()})
            return update(params, g, state)

        object.__setattr__(opt, "update_", record)       # the optimizer is frozen
    try:
        with _ReluInputs() as rec:
            gstate, cstate, _, _ = chip_smoke.two_train_steps(bundle, cpu, b, ipf, seed)
    finally:
        for bnd in (bundle, cpu):
            if "update_" in vars(bnd.dense_optimizer):
                object.__delattr__(bnd.dense_optimizer, "update_")
    gs, cs = rec.seen["cuda"], rec.seen["cpu"]
    if len(gs) != len(cs) or any(g.shape != c.shape for g, c in zip(gs, cs)):
        raise AssertionError("the card and the CPU called ReLU on other shapes")
    per_step = len(gs) // 2
    flips = []
    for i, (g, c) in enumerate(zip(gs, cs)):
        scale = float(c.abs().max())
        for idx in ((g > 0) != (c > 0)).nonzero().tolist():
            flips.append({"step": i // per_step + 1, "call": i % per_step,
                          "shape": list(g.shape), "index": idx,
                          "sample": _sample_of(g.shape, idx, b),
                          "card": float(g[tuple(idx)]), "cpu": float(c[tuple(idx)]),
                          "scale": scale})
    batch = synthetic_batch(cpu, b, seed=seed, ids_per_feature=ipf)[0]
    eng = cpu.embedding
    readers = {}                       # (storage, row) -> samples that look it up
    for key, col in eng.columns.items():
        if key not in batch:
            continue
        skey, offset, _ = eng.table_map[col.categorical_column.key]
        rows, mask = batch[key].rows.long() + offset, batch[key].mask > 0
        for s, r in (mask.nonzero().tolist()):
            readers.setdefault((skey, int(rows[s, r])), set()).add(s)
    flipped = {1: {f["sample"] for f in flips if f["step"] == 1},
               2: {f["sample"] for f in flips}}
    moment = (chip_smoke.TRAIN_MOMENT_TOL["atol"], chip_smoke.TRAIN_MOMENT_TOL["rtol"])
    tables = {}
    for n, tol in (("w", (chip_smoke.TRAIN_W_ATOL, 0.0)), ("m", moment), ("v", moment)):
        past = []
        for skey, ct in cstate.tables.items():
            got = gstate.tables[skey]["w" if n == "w" else "opt"]
            got = (got if n == "w" else got[n]).cpu()
            want = ct["w"] if n == "w" else ct["opt"][n]
            r = chip_smoke._ratio(got, want, *tol)
            past += [(skey, int(row)) for row in (~(r <= 1)).any(dim=1).nonzero().flatten()]
        by = {}
        for key in past:
            for s in readers.get(key, {-1}):
                by[s] = by.get(s, 0) + 1
        tables[n] = {"rows_past": len(past), "rows_by_sample": by,
                     **{f"rows_of_step{k}_flips": sum(1 for key in past
                                                     if readers.get(key, set()) & flipped[k])
                        for k in (1, 2)}}
    dense = {}
    for k, v in cstate.params.items():
        r = chip_smoke._ratio(gstate.params[k].cpu(), v, chip_smoke.TRAIN_W_ATOL, 0.0)
        idx = (~(r <= 1)).nonzero()
        if len(idx):
            dense[k] = _dense_past(idx, gstate, cstate, k, v, grads)
    return {"relu_calls_per_step": per_step, "flips": flips,
            "flipped_samples": {f"step{k}": sorted(v) for k, v in flipped.items()},
            "tables": tables, "dense_past": sum(d["entries"] for d in dense.values()),
            "dense": dense}


def _dense_past(idx, gstate, cstate, name, want, grads):
    """Where a dense parameter's entries past the tolerance sit (their rows
    and columns: a flipped unit's column of a kernel, or its row of the
    next) and how small their gradients are: the CPU's sqrt(nu) / (1 -
    b2^2)^(1/2) after two steps against Adam's eps, where a gradient within
    rounding of 0 makes the update mostly rounding; and, for the first few,
    each step's gradient on the card and on the CPU."""
    got = gstate.params[name].cpu()
    nu = cstate.opt_state["nu"][name]
    sel = tuple(idx.t())
    g_scale = (nu[sel] / (1 - 0.999 ** 2)).sqrt()
    return {"entries": len(idx), "shape": list(want.shape),
            "rows": sorted({int(i[0]) for i in idx})[:12],
            "cols": sorted({int(i[-1]) for i in idx})[:12] if want.ndim > 1 else [],
            "max_diff": float((got[sel] - want[sel]).abs().max()),
            "grad_scale": [float(g_scale.min()), float(g_scale.max())],
            "grads": [{"index": i.tolist(),
                       **{f"{side}{t + 1}": float(grads[side][t][name][tuple(i)])
                          for side in ("card", "cpu") for t in range(2)}}
                      for i in idx[:4]]}


def _runs():
    from recommendsystem_tpu_torch.core.config import synthetic_ctr_config

    ctr212 = {"cfg": synthetic_ctr_config(num_slots=180, num_bias=32)}
    # label -> (model, factory kwargs with chip_smoke's check bucket, ids a column)
    return {"autoint": ("autoint", {}, 5), "ctr": ("ctr", {"bucket_size": 16384}, 5),
            "ctr212": ("ctr", {**ctr212, "bucket_size": 4096}, 1),
            "multi_head": ("multi_head", {"bucket_size": 16384}, 5),
            "finish": ("finish", {"bucket_size": 8192}, 5)}


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
            w = witness(chip_smoke, create_model(name, device="cuda", **kw),
                        create_model(name, device="cpu", **kw), int(b), ipf, int(seed))
            w.update({"model": label, "batch": int(b), "seed": int(seed), "card": card})
            found.append(w)
            brief = {k: v for k, v in w.items() if k != "flips"}
            brief["flips"] = len(w["flips"])
            brief["flips_step1"] = [f for f in w["flips"] if f["step"] == 1][:8]
            print(json.dumps(brief), flush=True)
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
                m = chip_smoke.card_vs_cpu_margins(bundle, cpu, b, ipf, seed=seed)
                print(json.dumps({"model": label, "batch": b, "seed": seed,
                                  "margin": {n: v["margin"] for n, v in m.items()},
                                  "past": {n: v["past"] for n, v in m.items() if v["past"]},
                                  "s": time.perf_counter() - t0, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
