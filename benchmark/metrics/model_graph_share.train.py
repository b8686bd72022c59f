"""The share of the traced train steps whose stage 2 (the tower's forward
and backward) replayed a CUDA graph, in %: 100 x the traced ``step.train``
spans in which a ``model.graph`` span starts, over the traced
``step.train`` spans (the program's spans in the device-only trace's
window, ``harness/span_idle.py``).  0 on a program whose steps record no
``model.graph``; left out where no ``step.train`` span lies in the
window (a program without spans)."""

from harness import span_idle


def read(run):
    if run.entry != "train":
        return None
    records = span_idle.in_window(run.trace, span_idle._records())
    steps = [(a, b) for name, a, b, _ in records if name == "step.train"]
    if not steps:
        return None
    graphs = [a for name, a, _, _ in records if name == "model.graph"]
    held = sum(1 for a, b in steps if any(a <= g < b for g in graphs))
    return 100.0 * held / len(steps)
