"""The device's idle time by the layer the host was in
(``harness/span_idle.py`` and the ``<layer>_idle_share.<split>`` readers):
each tiny CPU cell's traced run reports its layers' shares, each between 0
and 100, and their sum within 2 points of the cell's
``device_idle_share``; the helper's base of the trace's clock is the one
the profiler exports; nested spans flatten to their innermost layer."""

from __future__ import annotations

import json
import os
import tempfile
import time

import pytest
import torch

CELLS = {"autoint.train": ("train", ["harness", "step", "embedding", "model"]),
         "staytime.train": ("train", ["harness", "step", "embedding", "model"]),
         "staytime.predict": ("predict", ["harness", "embedding", "model"])}
SEED = 2 ** 31 + 3119


def _warm_record_function() -> None:
    """The process's first ``record_function`` takes about 1 ms to enter,
    after its event's start: on the CPU, ``bench.window``'s, idle time
    before any span that a tiny window cannot absorb.  (A card's device
    trace starts its window at its first CUDA event, after that.)"""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.profiler.record_function("warm"):
            pass


@pytest.mark.parametrize("name", sorted(CELLS))
def test_traced_run_reports_idle_by_layer(tiny, name):
    from harness import runner

    split, layers = CELLS[name]
    _warm_record_function()
    result = runner.run_cell(tiny(name), SEED, 0.3, True, "cpu", time.time())
    assert result["correct"] is True
    got = result["metrics"]
    names = [f"{layer}_idle_share.{split}" for layer in layers]
    assert set(names) <= set(got)
    assert not any(k.endswith("_idle_share.train" if split == "predict"
                              else "_idle_share.predict") for k in got)
    for n in names:
        assert got[n]["unit"] == "%" and 0.0 <= got[n]["value"] <= 100.0
    total = sum(got[n]["value"] for n in names)
    assert abs(total - got[f"device_idle_share.{split}"]["value"]) < 2.0
    # the steps and the calls put the host in the embedding and model layers
    assert got[f"embedding_idle_share.{split}"]["value"] > 0
    assert got[f"model_idle_share.{split}"]["value"] > 0


def test_base_rule_is_the_exported_one():
    from harness import span_idle

    with tempfile.TemporaryDirectory() as tmp:
        before = time.time_ns()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            torch.ones(8).sum()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            exported = int(json.load(f)["baseTimeNanoseconds"])
    assert span_idle.base_ns(before) == exported
    assert span_idle.base_ns(exported) == exported
    assert exported % (span_idle.TRIMESTER_S * 10 ** 9) == 0


def test_innermost_flattens_nested_spans():
    from harness import span_idle

    segs = [(0, 10, 0, "harness"), (1, 9, 1, "step"), (2, 4, 2, "embedding"),
            (5, 8, 2, "model"), (12, 14, 0, "harness")]
    assert span_idle.innermost(segs) == [
        (0, 1, "harness"), (1, 2, "step"), (2, 4, "embedding"), (4, 5, "step"),
        (5, 8, "model"), (8, 9, "step"), (9, 10, "harness"), (12, 14, "harness")]


class _Trace:
    def __init__(self, t0, t1, busy):
        self.t0, self.t1, self._busy = t0, t1, busy

    def busy_intervals(self, work=False):
        return self._busy

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-6


class _Run:
    def __init__(self, trace, entry="train"):
        self.trace, self.entry = trace, entry

    def rank_mean(self, value):
        return value


def test_idle_charged_to_the_innermost_layer(monkeypatch):
    """Idle µs go to the innermost open span's layer, idle outside every
    span to none, and records outside the window are left out."""
    from harness import span_idle

    base = span_idle.base_ns(time.time_ns())
    us = lambda t: base + int(t * 1000)        # noqa: E731 (µs after the base, in ns)
    records = [("harness.step", us(100), us(200), 0), ("embedding.gather", us(110), us(150), 1),
               ("model.forward", us(150), us(190), 1), ("harness.step", us(500), us(600), 0)]
    monkeypatch.setattr(span_idle, "_records", lambda: records)
    run = _Run(_Trace(100.0, 300.0, [(120.0, 140.0), (160.0, 180.0)]))
    by = span_idle.idle_by_layer(run)
    assert by == pytest.approx({"harness": 20e-6, "embedding": 20e-6, "model": 20e-6})
    assert span_idle.share(run, "train", "model") == pytest.approx(10.0)
    assert span_idle.share(run, "train", "step") == 0.0
    assert span_idle.share(run, "predict", "model") is None
    monkeypatch.setattr(span_idle, "_records", lambda: [])      # cached on the run
    assert span_idle.idle_by_layer(run) is by


def test_no_spans_no_metric(monkeypatch):
    """A program that records no span (as one without spans): no metric,
    and no error."""
    from harness import span_idle

    monkeypatch.setattr(span_idle, "_records", lambda: [])
    assert span_idle.share(_Run(_Trace(0.0, 100.0, [])), "train", "harness") is None
