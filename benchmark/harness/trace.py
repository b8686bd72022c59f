"""A ``torch.profiler`` trace of a few steps, reduced to what the per-layer
metrics and the breakdown read.

The traced work ends in a synchronize, so every kernel it launched lies
inside its span.  A trace of the device alone (``host=False``: CUDA
activity, so the host pays little for it) gives the kernels and the busy
and idle time; its span runs from the first event to the last.  A trace
with the host's operations too (``host=True``: a slower host, so its idle
time reads high) runs the work inside a ``record_function("bench.window")``
span and gives what the host was doing in each idle gap.  The trace is
exported as Chrome JSON into a temporary directory and read back:

- device operations: events of the categories ``kernel``, ``gpu_memcpy``
  and ``gpu_memset`` (start and length in µs);
- ``busy_s``: the union of those intervals inside the span; ``window_s``:
  the span's length; ``work_s``: the same union without the NCCL kernels
  of a sharded step's exchange (``exchange_op``), which spin on the
  device while their rank waits for the others (equal to ``busy_s`` on
  one card);
- ``device_ops``: the ten operations that took most device time;
- ``idle_gaps``: the time the device sat idle inside the span, by the
  innermost host operation (``cpu_op`` or ``cuda_runtime``) running at
  the middle of each gap (``host (python)`` where none was), the ten
  largest.

The names of the port's kernels follow ``scripts/torch_profile_common.py``
(``port_kernel_us``): the part after ``(anonymous namespace)::`` and
before the template arguments.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime")
WINDOW = "bench.window"


def short_name(name: str) -> str:
    name = name.removeprefix("void ")
    if "(anonymous namespace)::" in name:
        name = name.split("(anonymous namespace)::", 1)[1]
    return name.split("(")[0].split("<")[0]


def exchange_op(name: str) -> bool:
    """A kernel of the exchange between ranks: an NCCL kernel."""
    return short_name(name).startswith("nccl")


class Trace:
    def __init__(self, events: List[dict]):
        span = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
                and e.get("cat") == "user_annotation"]
        timed = [e for e in events if e.get("ph") == "X" and "dur" in e
                 and e.get("cat") in DEVICE_CATS + HOST_CATS]
        if span:
            self.t0 = float(span[0]["ts"])
            self.t1 = self.t0 + float(span[0]["dur"])
        elif timed:
            self.t0 = min(float(e["ts"]) for e in timed)
            self.t1 = max(float(e["ts"]) + float(e["dur"]) for e in timed)
        else:
            raise RuntimeError("the trace holds no timed event")
        self.device = sorted((float(e["ts"]), float(e["dur"]), e["name"]) for e in events
                             if e.get("cat") in DEVICE_CATS and e.get("ph") == "X")
        self.host = sorted((float(e["ts"]), float(e["dur"]), e["name"]) for e in events
                           if e.get("cat") in HOST_CATS and e.get("ph") == "X")

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self, work: bool = False) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals inside the span;
        ``work``: without the exchange's (``exchange_op``)."""
        out: List[Tuple[float, float]] = []
        for ts, dur, name in self.device:
            if work and exchange_op(name):
                continue
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    @property
    def work_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals(work=True)) * 1e-6

    def kernel_seconds(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """Device seconds and count of the operations whose short name
        ``match`` accepts."""
        total, n = 0.0, 0
        for _, dur, name in self.device:
            if match(short_name(name)):
                total += dur
                n += 1
        return total * 1e-6, n

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for _, dur, name in self.device:
            key = short_name(name)
            by[key] = by.get(key, 0.0) + dur * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        gaps, cur = [], self.t0
        for a, b in self.busy_intervals():
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if self.t1 > cur:
            gaps.append((cur, self.t1))
        starts = [h[0] for h in self.host]
        by: Dict[str, float] = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            best = None
            i = bisect.bisect_right(starts, mid)
            for ts, dur, name in reversed(self.host[max(0, i - 400):i]):
                if ts + dur >= mid and (best is None or dur < best[0]):
                    best = (dur, name)
            key = best[1] if best else "host (python)"
            by[key] = by.get(key, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def traced(work: Callable[[], None], device, host: bool) -> Trace:
    """Run ``work`` under the profiler and return its trace: of the device
    alone, or with the host's operations where ``host`` (or where there
    is no card)."""
    on_card = torch.device(device).type == "cuda"
    activities = [torch.profiler.ProfilerActivity.CUDA] if on_card else []
    if host or not on_card:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW):
                work()
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize(device)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return Trace(events)
