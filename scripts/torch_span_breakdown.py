"""Where the host was while the card sat idle: one traced run of a benchmark
cell, read through the port's spans (``recommendsystem_tpu_torch/utils/
spans.py``).

    python3 scripts/torch_span_breakdown.py --workload autoint.train --seed 7 \
        [--seconds 5] [--out spans.json] [--clock]

Runs the cell as ``benchmark/run.py --trace 1`` does (``runner.run_cell``)
and prints, for the device-only trace of its traced steps: the window, the
busy time, the device's idle time by layer (``harness/span_idle.py``) and
the idle time with no span open; the prologue, from the window's start to
the first step's or call's first stage; each step's or call's host ms
(its ``harness.step`` or ``harness.predict`` span); and each span's host
self ms a step (its time less its children's), from the same records.  The result
line (``correct``, the metrics) goes into the JSON beside it.

``--clock`` (a train cell) checks the spans' clock instead: ``fit`` with
``profile_dir`` over 8 steps of the cell's batches, tracing steps 3-7 on
the host and the card, and each record against the exported
``user_annotation`` event of its name (``baseTimeNanoseconds`` from the
file): how far each event's start lies after its record's, and its end
before its record's.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
for _p in (BENCH, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FIRST_STAGE = {"train": "step.train", "predict": "embedding.lookup"}


def breakdown(run, records, steps: int) -> dict:
    """The window's numbers from the run's device trace and the span
    records (``spans.recorded()``)."""
    from harness import span_idle

    tr = run.trace
    inside = span_idle.in_window(tr, records)
    window_us = tr.t1 - tr.t0
    idle_us = window_us - tr.busy_s * 1e6
    by = span_idle.idle_by_layer(run) or {}
    first = min((a for n, a, _, _ in inside if n == FIRST_STAGE[run.entry]), default=tr.t0)
    outer = "harness.step" if run.entry == "train" else "harness.predict"
    step_ms = [(b - a) / 1e3 for n, a, b, d in inside if n == outer
               and any(d2 > d and a <= x and y <= b for _, x, y, d2 in inside)]
    self_us: dict = {}
    for name, a, b, depth in inside:
        kids = sum(y - x for n, x, y, d in inside if d == depth + 1 and a <= x and y <= b)
        self_us[name] = self_us.get(name, 0.0) + (b - a) - kids
    return {
        "window_ms": window_us / 1e3,
        "busy_ms": tr.busy_s * 1e3,
        "idle_share": 100.0 * idle_us / window_us,
        "idle_share_by_layer": {k: 100.0 * v * 1e6 / window_us for k, v in sorted(by.items())},
        "idle_share_no_span": 100.0 * (idle_us - sum(by.values()) * 1e6) / window_us,
        "prologue_ms": (first - tr.t0) / 1e3,
        "prologue_share": 100.0 * (first - tr.t0) / window_us,
        "steps": steps,
        "window_ms_a_step": window_us / 1e3 / steps,
        "step_ms": step_ms,
        "self_ms_a_step": {k: v / 1e3 / steps for k, v in
                           sorted(self_us.items(), key=lambda kv: -kv[1])},
    }


def clock_check(cell, seed: int, device) -> dict:
    """The records of a ``fit(profile_dir=...)`` trace against its events,
    in µs: the largest and least gap at each edge (a negative gap: an event
    outside its record)."""
    import tempfile

    from harness import program, weights
    from harness.traffic import Traffic
    from recommendsystem_tpu_torch.train.harness import fit
    from recommendsystem_tpu_torch.utils import spans

    bundle = program.build_bundle(cell.cfg, device)
    state, _ = weights.make_state(bundle, cell.cfg, cell.model.tables(cell.m), seed, device)
    gen = Traffic(cell.model, cell.m, cell.traffic, seed, device)
    items = [program.port_item(gen.batch(i, cell.traffic["batch"], 0)) for i in range(4)]
    spans.clear()
    with tempfile.TemporaryDirectory() as tmp:
        fit(bundle, items * 2, steps=8, state=state, seed=seed, log_every=0,
            profile_dir=tmp, profile_steps=(3, 8))
        with open(os.path.join(tmp, "trace.json")) as f:
            trace = json.load(f)
    base = int(trace["baseTimeNanoseconds"])
    events: dict = {}
    for e in sorted(trace["traceEvents"], key=lambda e: e.get("ts", 0)):
        if e.get("cat") == "user_annotation":
            events.setdefault(e["name"], []).append(e)
    t_first = min(float(e["ts"]) for v in events.values() for e in v)
    records: dict = {}
    for r in sorted(spans.recorded(), key=lambda r: r[1]):
        if (r[1] - base) / 1e3 >= t_first - 1e3:       # spans the profiler saw begin
            records.setdefault(r[0], []).append(r)
    start, end = [], []
    for name, recs in records.items():
        for (_, a, z, _), e in zip(recs, events.get(name, [])):
            start.append(float(e["ts"]) - (a - base) / 1e3)
            end.append((z - base) / 1e3 - float(e["ts"]) - float(e["dur"]))
    return {"matched": len(start), "events": sum(len(v) for v in events.values()),
            "base_ns": base, "start_gap_us": [min(start), max(start)],
            "end_gap_us": [min(end), max(end)]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default=None)
    p.add_argument("--clock", action="store_true")
    args = p.parse_args(argv)
    from harness.runner import process_start_epoch
    start_epoch = process_start_epoch()
    import torch

    from harness import cells, runner
    from recommendsystem_tpu_torch.utils import spans

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = cells.load(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    if args.clock:
        out = {"workload": args.workload, "card": torch.cuda.get_device_name(device),
               **clock_check(cell, args.seed, device)}
        return _write(out, args.out)
    got = {}
    per_layer = runner.per_layer

    def keep(cell_, run):
        got["run"], got["records"] = run, spans.recorded()
        return per_layer(cell_, run)

    runner.per_layer = keep
    result = runner.run_cell(cell, args.seed, args.seconds, True, device, start_epoch)
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(device),
           **breakdown(got["run"], got["records"], cell.traffic["trace_steps"]),
           "correct": result["correct"], "metrics": result["metrics"],
           "at": time.strftime("%Y-%m-%d %H:%M:%S")}
    return _write(out, args.out)


def _write(out: dict, path) -> int:
    text = json.dumps(out, indent=1)
    print(text)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
