"""``model_graph_share.train``: 100 x the traced ``step.train`` spans in
which a ``model.graph`` span starts, over the traced ``step.train`` spans.
On the CPU the train step replays no graph, so a tiny cell's traced run
reads 0 (as the program before the graph did); over planted records it
counts the steps that hold a replay, and is left out without spans."""

from __future__ import annotations

import time
import types

import pytest

SEED = 2 ** 31 + 2417


def _reader():
    from harness import cells

    return cells.load("staytime.train").reader("model_graph_share.train")


def test_a_tiny_cpu_train_cell_reads_zero(tiny):
    from harness import runner

    result = runner.run_cell(tiny("autoint.train"), SEED, 0.3, True, "cpu", time.time())
    assert result["correct"] is True
    assert result["metrics"]["model_graph_share.train"] == {"value": 0.0, "unit": "%"}


@pytest.mark.parametrize("records,want", [
    ([("step.train", 0, 10, 0), ("model.graph", 4, 6, 1),
      ("step.train", 10, 20, 0), ("model.forward", 12, 14, 1)], 50.0),
    ([("step.train", 0, 10, 0), ("model.graph", 4, 6, 1)], 100.0),
    ([("harness.step", 0, 10, 0)], None),
    ([], None),
])
def test_the_share_counts_the_steps_that_hold_a_replay(monkeypatch, records, want):
    from harness import span_idle

    monkeypatch.setattr(span_idle, "_records", lambda: [])
    monkeypatch.setattr(span_idle, "in_window", lambda tr, recs: records)
    run = types.SimpleNamespace(entry="train", trace=None)
    assert _reader().read(run) == want
    assert _reader().read(types.SimpleNamespace(entry="predict", trace=None)) is None
