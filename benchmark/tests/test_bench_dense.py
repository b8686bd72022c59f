"""Dense features in a configuration's batches (``harness/traffic.py``,
``reference/driver.py``, ``harness/program.py::port_item``), through the
tests' own configuration ``dense_tiny/`` (a bottom MLP over 13 counts
beside three id columns; its plain reference and its program beside it):
the runner trains and scores it on the CPU and comes out correct; with the
dense features zeroed on the program's side or on the reference's, or
half of each batch left out, it does not; the draw's law; a rank's rows
put together give the reference's whole batch; the other draws do not
move."""

from __future__ import annotations

import json
import os
import time
import types

import pytest
import torch

import faults
from conftest import tiny_cell

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dense_tiny")
SEED = 2 ** 31 + 6007
LAW = {"mu": 1.0, "sigma": 1.5}
# the cells whose tiny mixes and limits the dense configuration runs under
BASE = {"train": "autoint.train", "predict": "staytime.predict"}


def _reference():
    from harness import cells

    return cells.load_file(os.path.join(HERE, "reference.py"), "bench_dense_tiny_reference")


def _cell(entry: str):
    from harness import cells

    with open(os.path.join(HERE, "config.json")) as f:
        cfg = json.load(f)
    base = tiny_cell(BASE[entry])
    ref = _reference()

    class DenseCell(cells.Cell):
        model = ref

        def limits(self):
            return base.limits()

    return DenseCell(name=f"dense_tiny.{entry}", chips=1, cfg=cfg,
                     traffic=dict(base.traffic, dense=LAW), end_to_end=base.end_to_end,
                     per_layer=[])


@pytest.fixture
def dense_cell(tiny, monkeypatch):
    """The tests' dense configuration's cell, its program's factory
    registered for the test."""
    from harness import cells
    from recommendsystem_tpu_torch.models.base import MODEL_REGISTRY

    prog = cells.load_file(os.path.join(HERE, "program.py"), "bench_dense_tiny_program")
    monkeypatch.setitem(MODEL_REGISTRY, "bench_dense_tiny", prog.create)
    return _cell


def _run(cell):
    from harness import runner

    return runner.run_cell(cell, SEED, 0.3, False, "cpu", time.time())


@pytest.mark.parametrize("entry", ["train", "predict"])
def test_dense_configuration_runs_correct(dense_cell, entry):
    result = _run(dense_cell(entry))
    assert result["correct"] is True, result["checks"]
    for check in result["checks"].values():
        assert check["value"] <= 1e-5 and check["value"] < check["limit"]


@pytest.mark.parametrize("entry", ["train", "predict"])
def test_zeroed_dense_features_are_not_correct(dense_cell, entry):
    """The program reads the dense features: zeros in their place fail a
    check."""
    cell = dense_cell(entry)
    assert "dense_zeroed" in faults.faults_of(cell, sharded=False)
    with faults.planted("dense_zeroed", cell.cfg):
        result = _run(cell)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("entry", ["train", "predict"])
def test_the_reference_reads_the_dense_features(dense_cell, entry, monkeypatch):
    from reference import driver

    monkeypatch.setattr(driver, "dense_kwargs", lambda model, batch: {"dense": {
        k: torch.zeros_like(v) for k, v in batch["dense"].items()}})
    result = _run(dense_cell(entry))
    assert result["correct"] is False


def test_half_batch_cuts_the_dense_features(dense_cell):
    cell = dense_cell("train")
    with faults.planted("half_batch", cell.cfg):
        result = _run(cell)
    assert result["correct"] is False


def test_only_a_configuration_with_dense_features_has_their_fault():
    assert "dense_zeroed" not in faults.faults_of(tiny_cell("autoint.train"), sharded=True)


def _traffic(traffic=None, model=None, seed=SEED):
    from harness.traffic import Traffic

    cell = _cell("train")
    return Traffic(model or cell.model, cell.m, traffic or cell.traffic, seed, "cpu")


def test_dense_law_is_log1p_of_heavy_tailed_counts():
    gen = _traffic()
    x = gen.batch(0, 4096)["dense"]["counts"]
    assert x.shape == (4096, 13) and x.dtype == torch.float32
    exact = torch.expm1(x.double())
    counts = exact.round()
    assert bool((counts >= 0).all())
    assert torch.allclose(exact, counts, rtol=1e-6, atol=1e-6)
    # floor(exp(1 + 1.5 z)) is 0 for z < -2/3: P = 0.2525
    assert abs(float((counts == 0).double().mean()) - 0.2525) < 0.02
    assert float(counts.median()) == 2.0 and float(counts.max()) > 200.0
    again = _traffic().batch(0, 4096)["dense"]["counts"]
    other = _traffic(seed=SEED + 1).batch(0, 4096)["dense"]["counts"]
    assert torch.equal(x, again) and not torch.equal(x, other)


def test_dense_draws_leave_the_other_draws_alone():
    """The same mix and seed draw the same ids, masks, labels and weights
    whether the configuration has dense features or not."""
    ref = _reference()
    bare = types.SimpleNamespace(**{k: getattr(ref, k) for k in ("columns", "tables", "labels")})
    with_dense, without = _traffic().batch(2, 64, 128), _traffic(model=bare).batch(2, 64, 128)
    assert "dense" in with_dense and "dense" not in without
    for part in ("ids", "mask", "labels"):
        for k in without[part]:
            assert torch.equal(with_dense[part][k], without[part][k])
    assert torch.equal(with_dense["weight"], without["weight"])


def test_ranks_dense_rows_make_the_whole_batch():
    """Rank r of a 4-rank cell draws rows [r b, (r + 1) b) of each batch;
    the reference's whole batch is the ranks' rows put together."""
    from harness import runner

    cell = _cell("train")
    b = cell.traffic["batch"]
    s = runner.Session(cell, SEED, 0.1, "cpu", 0.0, types.SimpleNamespace(rank=0, world=4))
    s.gen = _traffic()
    whole = s.global_batch(3)
    parts = [_traffic().batch(3, b, r * b) for r in range(4)]
    assert whole["dense"]["counts"].shape == (4 * b, 13)
    for r, part in enumerate(parts):
        assert torch.equal(whole["dense"]["counts"][r * b:(r + 1) * b], part["dense"]["counts"])
        assert torch.equal(whole["ids"]["a"][r * b:(r + 1) * b], part["ids"]["a"])
    assert not torch.equal(parts[0]["dense"]["counts"], parts[1]["dense"]["counts"])


def test_a_mix_without_the_law_is_refused():
    cell = _cell("train")
    traffic = {k: v for k, v in cell.traffic.items() if k != "dense"}
    with pytest.raises(ValueError, match="dense"):
        _traffic(traffic=traffic)
