"""The device's idle time in the traced steps put down to the layer the
host was in: the program's spans (``recommendsystem_tpu_torch/utils/
spans.py``) laid over the device trace (``trace.Trace``).

The program records each span as ``(name, start_ns, end_ns, depth)`` in
unix nanoseconds, the profiler's own host clock; the exported trace gives
its events in µs after ``baseTimeNanoseconds``, which Kineto takes as the
trace's unix time rounded down to a multiple of ``TRIMESTER_S`` seconds
(``base_ns``).  The records are kept where they overlap the trace's
window, which leaves out the spans of the host-and-device trace that
follows it.  Each µs in which the window's device ran nothing is charged
to the layer of the innermost span open on the host then (a span's layer:
its name before the dot); time with no span open goes to no layer.  The
exchange's NCCL kernels count as idle (``Trace.busy_intervals(work=
True)``): they spin while their rank waits for the others.  On a sharded
cell a share is the mean over the ranks.

A program without spans gives no records, and then ``idle_by_layer`` gives
None and the metrics that read it are left out.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

TRIMESTER_S = 7_889_238
_CACHE = "_span_idle"


def base_ns(unix_ns: int) -> int:
    """The ``baseTimeNanoseconds`` of a trace taken at ``unix_ns``."""
    return unix_ns // 1_000_000_000 // TRIMESTER_S * TRIMESTER_S * 1_000_000_000


def _records() -> List[Tuple[str, int, int, int]]:
    try:
        from recommendsystem_tpu_torch.utils import spans
    except ImportError:             # a program without spans
        return []
    return spans.recorded()


def in_window(tr, records) -> List[Tuple[str, float, float, int]]:
    """The records that overlap the trace's window, as ``(name, start,
    end, depth)`` in the trace's µs, cut to the window."""
    out = []
    for name, start, end, depth in records:
        base = base_ns(start)
        a, b = max((start - base) / 1e3, tr.t0), min((end - base) / 1e3, tr.t1)
        if b > a:
            out.append((name, a, b, depth))
    return out


def innermost(segments: List[Tuple[float, float, int, str]]) -> List[Tuple[float, float, str]]:
    """Nested spans ``(start, end, depth, layer)`` flattened to disjoint
    ``(start, end, layer)`` pieces, each the layer of the innermost span
    open over it."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []       # (end, layer) of the open spans
    t = None

    def emit(upto: float) -> None:
        nonlocal t
        if stack and upto > t:
            out.append((t, upto, stack[-1][1]))
        t = upto if t is None else max(t, upto)

    for a, b, _, layer in sorted(segments, key=lambda s: (s[0], s[2])):
        while stack and stack[-1][0] <= a:
            emit(stack[-1][0])
            stack.pop()
        emit(a)
        stack.append((b, layer))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    return out


def idle_by_layer(run) -> Optional[Dict[str, float]]:
    """{layer: device idle seconds in the window while the host was in
    it}, computed once a run; None where no span lies in the window."""
    if hasattr(run, _CACHE):
        return getattr(run, _CACHE)
    tr = run.trace
    segments = [(a, b, depth, name.split(".", 1)[0])
                for name, a, b, depth in in_window(tr, _records())]
    out = None
    if segments:
        idle, cur = [], tr.t0
        for a, b in tr.busy_intervals(work=True):
            if a > cur:
                idle.append((cur, a))
            cur = max(cur, b)
        if tr.t1 > cur:
            idle.append((cur, tr.t1))
        out = {}
        pieces = innermost(segments)
        j = 0
        for a, b in idle:               # both lists sorted and disjoint
            while j < len(pieces) and pieces[j][1] <= a:
                j += 1
            k = j
            while k < len(pieces) and pieces[k][0] < b:
                lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
                if hi > lo:
                    layer = pieces[k][2]
                    out[layer] = out.get(layer, 0.0) + (hi - lo) * 1e-6
                k += 1
    setattr(run, _CACHE, out)
    return out


def share(run, entry: str, layer: str) -> Optional[float]:
    """100 x the window's device idle seconds charged to ``layer`` over
    the window's length, in a run of ``entry``; None elsewhere."""
    if run.entry != entry:
        return None
    by = idle_by_layer(run) if run.trace.window_s > 0 else None
    mine = None if by is None else 100.0 * by.get(layer, 0.0) / run.trace.window_s
    return run.rank_mean(mine)
