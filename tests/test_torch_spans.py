"""The port's spans (``utils/spans.py``) at the layer boundaries of
``harness.fit``, the train step and ``harness.predict``.

With no profiler active a span records nothing and enters no
``record_function``.  Under ``torch.profiler`` (CPU activity) a tiny
autoint's and a tiny staytime's ``fit`` of 2 steps and ``predict`` of 2
calls record the span tree in order: each ``harness.step`` holds one
``step.train``, which holds the six stages; each record encloses the
exported ``user_annotation`` event of its name, on the profiler's own
clock.  A tiny DLRM-DCNv2's ``model.forward`` holds its
``model.cross``.  The scatter and dense updates name the stages they have; the
store keeps at most its bound.
"""

import json
import os

import pytest
import torch

from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
from recommendsystem_tpu_torch.train import create_train_state, fit, make_train_step
from recommendsystem_tpu_torch.train.harness import predict
from recommendsystem_tpu_torch.utils import spans

torch.set_num_threads(1)
B = 16
STAGES = ["embedding.plan", "embedding.gather", "model.forward", "model.backward",
          "step.dense_update", "embedding.update"]
PREDICT = ["embedding.lookup", "model.forward", "harness.to_host"]
EDGE_US = 500.0       # record_function's own enter and exit on a slow host
CLOCK_US = 5.0        # the profiler's clock against time.time_ns()


def _bundle(name):
    if name == "staytime":
        return create_model("staytime", cfg=StaytimeConfig(bucket_size=128, seq_max_len=4),
                            device="cpu")
    return create_model("autoint", bucket_size=64, device="cpu")


def _run(bundle):
    """``fit`` of 2 steps, then ``predict`` of 2 calls on the same batches."""
    data = [synthetic_batch(bundle, B, seed=40 + i) for i in range(2)]
    state = fit(bundle, iter(data), steps=2, seed=0, log_every=0)
    return list(predict(bundle, iter(data), state))


def _profiled(work):
    """``work()`` under a CPU profiler, after a first ``record_function`` (the
    process's first takes about 1 ms to enter); the exported trace."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.profiler.record_function("warm"):
            pass
    spans.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        work()
    return prof


def _tree(records):
    """The records as nested ``[name, [children]]`` lists in start order."""
    roots, stack = [], []
    for name, start, end, depth in sorted(records, key=lambda r: (r[1], r[3])):
        node = [name, []]
        while stack and stack[-1][1] <= start:
            stack.pop()
        assert len(stack) == depth, (name, [s[0][0] for s in stack])
        (stack[-1][0][1] if stack else roots).append(node)
        stack.append((node, end))
    return roots


def _shape(node):
    return (node[0], [_shape(c) for c in node[1]])


@pytest.mark.parametrize("model", ["autoint", "staytime"])
def test_no_profiler_records_nothing(model, monkeypatch):
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: entered.append(a) or real(*a, **k))
    spans.clear()
    outputs = _run(_bundle(model))
    assert len(outputs) == 2
    assert spans.recorded() == [] and entered == []
    assert spans.span("harness.fit") is spans.span("model.forward")    # the shared null


@pytest.mark.parametrize("model", ["autoint", "staytime"])
def test_span_tree_of_fit_and_predict(model):
    bundle = _bundle(model)
    _profiled(lambda: _run(bundle))
    roots = [_shape(n) for n in _tree(spans.recorded())]
    step = ("harness.step", [("step.train", [(s, []) for s in STAGES])])
    call = ("harness.predict", [(s, []) for s in PREDICT])
    assert roots == [("harness.fit", [step, step]), call, call,
                     ("harness.predict", [])]        # the end of the dataset


@pytest.mark.parametrize("model", ["autoint", "staytime"])
def test_records_enclose_their_trace_events(model, tmp_path):
    bundle = _bundle(model)
    prof = _profiled(lambda: _run(bundle))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace["baseTimeNanoseconds"])
    events = {}
    for e in sorted(trace["traceEvents"], key=lambda e: e.get("ts", 0)):
        if e.get("cat") == "user_annotation" and e["name"] != "warm":
            events.setdefault(e["name"], []).append(e)
    records = {}
    for r in sorted(spans.recorded(), key=lambda r: r[1]):
        records.setdefault(r[0], []).append(r)
    assert {k: len(v) for k, v in records.items()} == {k: len(v) for k, v in events.items()}
    for name, recs in records.items():
        for (_, start, end, _), e in zip(recs, events[name]):
            a, z = (start - base) / 1e3, (end - base) / 1e3
            ea, ez = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            assert a <= ea + CLOCK_US and z >= ez - CLOCK_US, (name, a, ea, z, ez)
            assert ea - a < EDGE_US and z - ez < EDGE_US, (name, ea - a, z - ez)


def test_cross_span_nests_in_the_forward():
    bundle = create_model("dlrm_dcnv2", rows=[64] * 26, device="cpu")
    _profiled(lambda: _run(bundle))
    roots = [_shape(n) for n in _tree(spans.recorded())]
    forward = ("model.forward", [("model.cross", [])])
    step = ("harness.step", [("step.train", [forward if s == "model.forward" else (s, [])
                                             for s in STAGES])])
    call = ("harness.predict", [forward if s == "model.forward" else (s, [])
                                for s in PREDICT])
    assert roots == [("harness.fit", [step, step]), call, call, ("harness.predict", [])]


@pytest.mark.parametrize("update,stages", [
    ("scatter", ["embedding.gather", "model.forward", "model.backward",
                 "step.dense_update", "embedding.update"]),
    ("dense", ["model.forward", "model.backward", "step.dense_update",
               "embedding.update"])])
def test_classic_updates_name_their_stages(update, stages):
    bundle = _bundle("autoint")
    state = create_train_state(bundle, seed=0)
    batch, dense, labels, weight = synthetic_batch(bundle, B, seed=1)
    step = make_train_step(bundle, sparse_update=update)
    _profiled(lambda: step(state, batch, labels, weight, dense, seed=3))
    assert [_shape(n) for n in _tree(spans.recorded())] == [
        ("step.train", [(s, []) for s in stages])]


def test_store_keeps_its_bound():
    def many():
        for i in range(spans.BOUND + 10):
            with spans.span("harness.step"):
                pass

    _profiled(many)
    got = spans.recorded()
    assert len(got) == spans.BOUND
    assert got[0][1] <= got[-1][1] and all(r[0] == "harness.step" for r in got)
    spans.clear()
    assert spans.recorded() == []
