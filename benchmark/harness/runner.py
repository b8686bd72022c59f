"""One run of one cell: set-up, the measured window, the traced steps, the
check against the reference, and the result line.

Order of a run:

1. set-up (``setup_s``, from the process's start to the window's start):
   the program's bundle, the weights and the batch pool on the device
   from the seed, the first steps (``check_steps`` train steps through the
   window's own call, ``fit``, on distinct batches, whose losses, first
   gradients and changes the check reads), then ``warm_steps`` more steps
   or calls over the pool, so that every kernel is built and loaded;
2. the window: ``--seconds`` of steps (``fit``) or calls
   (``harness.predict``) cycling through the pool, ended by a synchronize
   and one host fetch of the last loss (a call's scores are copied to the
   host each call), with Python's garbage collector off and the set-up's
   objects frozen out of its reach;
3. with ``--trace 1``: ``trace_steps`` more steps under the profiler, for
   the per-layer metrics and the breakdown;
4. the peak memory read, the program's state freed, then the reference
   from the same weights and batches (train: the check steps; predict: a
   sample of the window's calls drawn from the seed), and the numbers
   compared against their limits.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import random
import sys
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from . import compare, program, weights
from .cells import Cell
from .trace import Trace, traced
from .traffic import Traffic, mix
from reference import driver

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "recommendsystem_tpu")


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def process_start_epoch() -> float:
    """The wall-clock time this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _alone(value) -> list:
    return [value]


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads (``metrics/<name>.py``).  On a
    sharded cell every rank reads every metric, in the same order, so a
    reader may ``gather`` a value from each rank (a collective: a reader
    that gathers does so on every rank, whatever it returns)."""

    m: dict
    entry: str
    counts: object
    trace: Trace
    traced_batches: List[dict]
    step_s: float
    world: int
    rank: int = 0
    # this rank's value and every other rank's, in rank order
    gather: Callable[[object], list] = _alone
    # traced step k's batch over every rank (the reference's batch)
    whole_batch: Optional[Callable[[int], dict]] = None

    def rank_mean(self, value: Optional[float]) -> Optional[float]:
        """``value`` on one card; on a sharded cell its mean over the
        ranks, None where a rank's is None (a collective)."""
        if self.world == 1:
            return value
        values = self.gather(value)
        return None if any(v is None for v in values) else sum(values) / len(values)

    def step_least_s(self) -> float:
        """A step's least time on one chip, from this rank's batches (on a
        sharded cell each rank's share of the work)."""
        from .peaks import least_seconds
        per = [least_seconds(b, f) for f, b in
               (self.counts.step(self.m, self.entry, x) for x in self.traced_batches)]
        return sum(per) / len(per)

    def kernel_share(self, name: str, match, shard: bool = False) -> Optional[float]:
        """100 x the kernel's least time over its device time in the trace;
        None where the trace holds no such kernel or the configuration
        counts none.  ``shard``: the kernel's work on this rank's shard of
        the tables, counted from the whole batch's ids that its rows own
        (``counts`` ``kernel(..., shard=(rank, world))``)."""
        from .peaks import least_seconds
        dev_s, n = self.trace.kernel_seconds(match)
        if shard:
            counted = [self.counts.kernel(self.m, name, self.whole_batch(k),
                                          shard=(self.rank, self.world))
                       for k in range(len(self.traced_batches))]
        else:
            counted = [self.counts.kernel(self.m, name, b) for b in self.traced_batches]
        if n == 0 or dev_s <= 0 or any(c is None for c in counted):
            return None
        return 100.0 * sum(least_seconds(*c) for c in counted) / dev_s


class Mesh:
    """The ranks of a sharded cell: the program's mesh, and a gloo group
    on the host for the harness's own agreement (when to stop, the
    results)."""

    def __init__(self, rank: int, world: int, port: int, device):
        self.mesh = program.mesh_up(rank, world, port, device)
        self.host = dist.new_group(backend="gloo")
        self.rank, self.world = rank, world

    def stop(self, mine: bool) -> bool:
        flag = torch.tensor([int(mine)])
        dist.broadcast(flag, src=0, group=self.host)
        return bool(flag.item())

    def gather(self, obj) -> list:
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.host)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.host)


def cpu_times() -> List[int]:
    """The host's CPU time counters (``/proc/stat``: user, nice, system,
    idle, iowait, irq, softirq, steal), in ticks."""
    with open("/proc/stat") as f:
        return [int(x) for x in f.readline().split()[1:9]]


def pin_to_one_core(rank: int) -> int:
    """Keep every thread of this process, and every thread it starts
    later, on one core of those it may use: rank r on the (r + 1)-th, so
    that ranks do not share one and core 0, which serves most interrupts,
    stays free.  The core."""
    cores = sorted(os.sched_getaffinity(0))
    core = cores[(rank + 1) % len(cores)]
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), {core})
        except ProcessLookupError:      # a thread that has just ended
            pass
    return core


def _feed(items, start: int, deadline: float, ranks: Optional[Mesh], counter: list,
          stamps: list):
    i = start
    while True:
        now = time.perf_counter()
        stamps.append(now)
        stop = now >= deadline
        if ranks is not None:
            stop = ranks.stop(stop)
        if stop:
            return
        counter.append(i % len(items))
        yield items[i % len(items)]
        i += 1


class Session:
    def __init__(self, cell: Cell, seed: int, seconds: float, device, start_epoch: float,
                 ranks: Optional[Mesh] = None):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.device = torch.device(device)
        self.start_epoch, self.ranks = start_epoch, ranks
        self.rank = ranks.rank if ranks else 0
        self.world = ranks.world if ranks else 1
        self.t = cell.traffic
        self.model = cell.model
        self.core = None

    # -- set-up ---------------------------------------------------------------

    def setup(self):
        cell, m = self.cell, self.cell.m
        self.bundle = program.build_bundle(cell.cfg, self.device, self.world)
        state, self.init = weights.make_state(self.bundle, cell.cfg, self.model.tables(m),
                                              self.seed, self.device)
        if self.ranks is not None:
            state = program.shard_state(self.bundle, state, self.ranks.mesh)
            gc.collect()
        self.state = state
        self.gen = Traffic(self.model, m, self.t, self.seed, self.device)
        b = self.t["batch"]
        self.pool = [self.gen.batch(i, b, self.rank * b) for i in range(self.t["pool"])]
        self.items = [program.port_item(x) for x in self.pool]
        self.check_seeds = [s for s, _ in zip(program.seed_stream(
            program.fit_seed(self.seed, 0)), range(self.t.get("check_steps", 0)))]
        self.drops = None
        if self.ranks is not None:      # every batch of the pool; the report sums the ranks
            self.drops = sum(v["rows"] for x in self.pool for v in
                             program.drop_report(self.bundle, x, self.ranks.mesh).values())
            if self.rank == 0:
                print(f"exchange drops over the pool: {self.drops}", file=sys.stderr,
                      flush=True)
        if self.rank != 0:
            self.init = None

    def whole_state(self, state):
        if self.ranks is None:
            return state
        return program.gather_state(self.bundle, state, self.ranks.mesh)

    def check_steps(self) -> dict:
        n = self.t["check_steps"]
        losses, grads = [], {}
        tables = self.model.tables(self.cell.m)

        def on_step(i, st, info):
            losses.append(info["loss"].detach().clone())
            if i == 1:
                whole = self.whole_state(st)
                if self.rank == 0:
                    grads.update(weights.read_grads(self.bundle, whole, self.cell.cfg, tables))
                del whole

        mesh = self.ranks.mesh if self.ranks else None
        self.state = program.fit(self.bundle, self.items[:n], n, self.state,
                                 program.fit_seed(self.seed, 0), [on_step], mesh)
        whole = self.whole_state(self.state)
        change = (weights.read_changes(self.bundle, whole, self.init, tables)
                  if self.rank == 0 else {})
        del whole
        return {"loss": [float(x) for x in losses], "grad_state": grads, "change": change}

    def warm(self):
        n0, w = self.t.get("check_steps", 0), self.t["warm_steps"]
        items = [self.items[(n0 + i) % len(self.items)] for i in range(w)]
        if self.t["entry"] == "train":
            mesh = self.ranks.mesh if self.ranks else None
            self.state = program.fit(self.bundle, items, w, self.state,
                                     program.fit_seed(self.seed, 1), (), mesh)
        else:
            for _ in program.predict(self.bundle, items, self.state):
                pass
        self.next_item = n0 + w
        sync(self.device)

    # -- the window -----------------------------------------------------------

    def window(self) -> dict:
        if self.device.type == "cuda":       # after set-up, whose build uses every core
            self.core = pin_to_one_core(self.rank)
        if self.ranks is not None:
            self.ranks.barrier()
        order: list = []
        self.stamps: list = []
        self.cpu0 = cpu_times()
        t0 = time.perf_counter()
        self.setup_s = time.time() - self.start_epoch
        feed = _feed(self.items, self.next_item, t0 + self.seconds, self.ranks, order,
                     self.stamps)
        b = self.t["batch"]
        gc.freeze()            # no collection pauses inside the window
        gc.disable()
        if self.t["entry"] == "train":
            last = {}

            def on_step(i, st, info):
                last["loss"] = info["loss"]

            mesh = self.ranks.mesh if self.ranks else None
            self.state = program.fit(self.bundle, feed, None, self.state,
                                     program.fit_seed(self.seed, 2), [on_step], mesh)
            final_loss = float(last["loss"])
            t1 = time.perf_counter()
            self.sample = []
        else:
            rng = random.Random(mix(self.seed, 0x73616D70))
            keep = self.t["check_calls"]
            sample = []
            for n, (_, outputs) in enumerate(program.predict(self.bundle, feed, self.state)):
                if len(sample) < keep:
                    sample.append((n, outputs))
                else:
                    j = rng.randrange(n + 1)
                    if j < keep:
                        sample[j] = (n, outputs)
            t1 = time.perf_counter()
            final_loss = None
            self.sample = [(order[n], outputs) for n, outputs in sample]
        gc.enable()
        gc.unfreeze()
        self.next_item += len(order)
        self.cpu1 = cpu_times()
        steps = len(order)
        return {"steps": steps, "seconds": t1 - t0, "examples": steps * b * self.world,
                "final_loss": final_loss}

    def traced_steps(self) -> tuple:
        """(a trace of the device over ``trace_steps`` steps, a trace with
        the host's operations over ``trace_host_steps`` more, the batches
        of the first)."""
        n, n_host = self.t["trace_steps"], self.t.get("trace_host_steps", 3)
        idx = [(self.next_item + i) % len(self.items) for i in range(n + n_host)]
        mesh = self.ranks.mesh if self.ranks else None

        def work(part, phase):
            items = [self.items[i] for i in part]
            if self.t["entry"] == "train":
                self.state = program.fit(self.bundle, items, len(items), self.state,
                                         program.fit_seed(self.seed, phase), (), mesh)
            else:
                for _ in program.predict(self.bundle, items, self.state):
                    pass
        device = traced(lambda: work(idx[:n], 3), self.device, host=False)
        host = traced(lambda: work(idx[n:], 4), self.device, host=True)
        self.traced_idx = idx[:n]
        return device, host, [self.pool[i] for i in idx[:n]]

    def free_program(self) -> None:
        self.state = self.bundle = self.items = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------

    def global_batch(self, i: int) -> dict:
        """Batch ``i`` of the pool over every rank (the reference's batch)."""
        if self.world == 1:
            return self.pool[i]
        b = self.t["batch"]
        parts = [self.gen.batch(i, b, r * b) for r in range(self.world)]
        cat = lambda key: {k: torch.cat([p[key][k] for p in parts]) for k in parts[0][key]}  # noqa: E731
        whole = {key: cat(key) for key in ("ids", "mask", "labels", "dense") if key in parts[0]}
        return dict(whole, weight=torch.cat([p["weight"] for p in parts]))

    def reference_numbers(self, prog: Optional[dict], tf32: bool = False) -> Dict[str, float]:
        m = self.cell.m
        if self.t["entry"] == "train":
            batches = [self.global_batch(i) for i in range(self.t["check_steps"])]
            ref = driver.train(self.model, m, self.init, batches, self.check_seeds,
                               self.device)
            if prog is None:       # the control: the reference in TF32 in the program's place
                prog = driver.train(self.model, m, self.init, batches, self.check_seeds,
                                    self.device, tf32=True)
            self.diagnostics = compare.diagnostics(prog, ref)
            return compare.train_numbers(prog, ref)
        worst = 0.0
        for i, outputs in self.sample:
            batch = self.pool[i]
            ref = driver.predict(self.model, m, self.init, batch, self.device)
            got = outputs if not tf32 else driver.predict(self.model, m, self.init, batch,
                                                          self.device, tf32=True)
            worst = max(worst, compare.score_gap(got, ref))
        return {"score": worst}


def per_layer(cell: Cell, run: Run) -> dict:
    out = {}
    for metric in cell.per_layer:
        value = cell.reader(metric["name"]).read(run)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             start_epoch: float, ranks: Optional[Mesh] = None) -> Optional[dict]:
    """One run; the result on rank 0 (None on the other ranks)."""
    s = Session(cell, seed, seconds, device, start_epoch, ranks)
    marks = [("start", start_epoch), ("imports", time.time())]
    s.setup()
    sync(s.device)
    marks.append(("weights and pool", time.time()))
    prog = s.check_steps() if cell.traffic["entry"] == "train" else None
    sync(s.device)
    marks.append(("check steps", time.time()))
    s.warm()
    marks.append(("warm-up", time.time()))
    probe = time.perf_counter()
    sum(i * i for i in range(1_000_000))
    probe = time.perf_counter() - probe
    win = s.window()
    if s.rank == 0:
        print(f"host probe: {probe * 1e3:.1f} ms for 1e6 Python multiply-adds; the window "
              f"on core {s.core}", file=sys.stderr)
        d = [b - a for a, b in zip(s.cpu0, s.cpu1)]
        print(f"host during the window: steal {100 * d[7] / max(1, sum(d)):.1f} %, "
              f"idle {100 * d[3] / max(1, sum(d)):.1f} % of all cores", file=sys.stderr)
        if s.stamps:
            t0 = s.stamps[0]
            per = [0] * (int(s.stamps[-1] - t0) + 1)
            for t in s.stamps[1:]:
                per[int(t - t0)] += 1
            print(f"steps a second: {per}", file=sys.stderr)
        print("set-up: " + ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b)
                                     in zip(marks, marks[1:])), file=sys.stderr, flush=True)
    rank0 = s.rank == 0
    metrics, breakdown, dev = {}, None, {}
    if trace:
        tr, tr_host, batches = s.traced_steps()
    # before the readers, which may draw the whole batches on the device
    peak = torch.cuda.max_memory_allocated(s.device) if s.device.type == "cuda" else 0
    if ranks is not None:
        peak = max(ranks.gather(peak))
    if trace:
        run = Run(cell.m, cell.traffic["entry"], cell.counts, tr, batches,
                  win["seconds"] / max(1, win["steps"]), s.world, s.rank,
                  ranks.gather if ranks else _alone,
                  lambda k: s.global_batch(s.traced_idx[k]))
        busy = [tr.busy_s] if ranks is None else ranks.gather(tr.busy_s)
        window_s = [tr.window_s] if ranks is None else ranks.gather(tr.window_s)
        metrics = per_layer(cell, run)
        dev = {"busy_s": sum(busy) / len(busy), "window_s": sum(window_s) / len(window_s)}
        breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr_host.idle_gaps()}
    else:
        for e in cell.end_to_end:
            if e["name"] == "setup_s":
                value = s.setup_s
            else:
                value = win["examples"] / win["seconds"]
            metrics[e["name"]] = {"value": value, "unit": e["unit"]}
    s.free_program()
    if ranks is not None:
        ranks.barrier()
    if not rank0:
        return None
    numbers = s.reference_numbers(prog)
    limits = cell.limits()
    if s.drops is not None:        # a dropped entry is an answer the reference lacks
        numbers["drops"], limits["drops"] = float(s.drops), 0.0
    correct = compare.judge(numbers, limits)
    kind = (torch.cuda.get_device_name(s.device) if s.device.type == "cuda" else "cpu")
    result = {
        "correct": correct,
        "attempted": win["steps"],
        "failed": 0 if correct else win["steps"],
        "metrics": metrics,
        "device": {"platform": "gpu" if s.device.type == "cuda" else "cpu", "kind": kind,
                   "count": s.world, "memory_peak_bytes": int(peak), **dev},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": numbers.get(k, float("nan")), "limit": lim}
                        for k, lim in limits.items()}
    return result
