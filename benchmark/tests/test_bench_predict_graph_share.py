"""``step_graph_share.predict``: 100 x the traced predict calls in which a
``step.graph`` span starts, over the traced calls, a call being a
``harness.predict`` span in which a ``harness.to_host`` span starts.  On
the CPU the predict step replays no graph, so a tiny cell's traced run
reads 0 (as the program before the graph did); over planted records it
counts the calls that hold a replay, leaves out the ``harness.predict``
span that ends the iteration, and is left out without calls."""

from __future__ import annotations

import time
import types

import pytest

SEED = 2 ** 31 + 2749


def _reader():
    from harness import cells

    return cells.load("staytime.predict").reader("step_graph_share.predict")


def test_a_tiny_cpu_predict_cell_reads_zero(tiny):
    from harness import runner

    result = runner.run_cell(tiny("staytime.predict"), SEED, 0.3, True, "cpu", time.time())
    assert result["correct"] is True
    assert result["metrics"]["step_graph_share.predict"] == {"value": 0.0, "unit": "%"}


def _call(a, b, graph=True):
    """The spans of one call from ``a`` to ``b``: its replay (or its eager
    lookup) and its copy to the host."""
    inner = ("step.graph" if graph else "embedding.lookup", a + 1, a + 3, 1)
    return [("harness.predict", a, b, 0), inner, ("harness.to_host", b - 2, b - 1, 1)]


@pytest.mark.parametrize("records,want", [
    (_call(0, 10) + _call(10, 20, graph=False), 50.0),
    (_call(0, 10) + _call(10, 20) + [("harness.predict", 20, 21, 0)], 100.0),
    (_call(0, 10, graph=False) + [("harness.predict", 10, 11, 0)], 0.0),
    ([("harness.predict", 0, 10, 0), ("step.graph", 4, 6, 1)], None),
    ([("step.graph", 4, 6, 1)], None),
    ([], None),
])
def test_the_share_counts_the_calls_that_hold_a_replay(monkeypatch, records, want):
    from harness import span_idle

    monkeypatch.setattr(span_idle, "_records", lambda: [])
    monkeypatch.setattr(span_idle, "in_window", lambda tr, recs: records)
    run = types.SimpleNamespace(entry="predict", trace=None)
    assert _reader().read(run) == want
    assert _reader().read(types.SimpleNamespace(entry="train", trace=None)) is None
