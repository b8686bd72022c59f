"""The share of the traced predict calls that replayed a CUDA graph (the
lookup and the forward), in %: 100 x the traced calls in which a
``step.graph`` span starts, over the traced calls (the program's spans in
the device-only trace's window, ``harness/span_idle.py``).  A call is a
``harness.predict`` span in which a ``harness.to_host`` span starts (the
call's copy of its scores); the ``harness.predict`` span that ends the
iteration holds no call and is not counted.  0 on a program whose calls
record no ``step.graph``; left out where no call lies in the window (a
program without spans)."""

from harness import span_idle


def read(run):
    if run.entry != "predict":
        return None
    records = span_idle.in_window(run.trace, span_idle._records())
    starts = {}
    for name, a, _, _ in records:
        starts.setdefault(name, []).append(a)

    def holds(a, b, name):
        return any(a <= s < b for s in starts.get(name, ()))

    calls = [(a, b) for name, a, b, _ in records
             if name == "harness.predict" and holds(a, b, "harness.to_host")]
    if not calls:
        return None
    return 100.0 * sum(1 for a, b in calls if holds(a, b, "step.graph")) / len(calls)
