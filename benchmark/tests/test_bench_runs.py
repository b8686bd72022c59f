"""Whole runs of each cell on the CPU at a tiny size, through the program's
plain CPU paths: the reference agrees with the program (the numbers far
under the committed limits, ``correct`` true), and a run with the timed
path broken underneath comes out not correct, once for each fault the
cell can have.  The look for a chip (``run.py``) is skipped: the run is
driven from ``runner.run_cell``."""

from __future__ import annotations

import time

import pytest

import faults

CELLS = ["autoint.train", "staytime.train", "staytime.predict"]
SEED = 2 ** 31 + 977


def _run(cell, trace=False):
    from harness import runner

    return runner.run_cell(cell, SEED, 0.3, trace, "cpu", time.time())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny, name):
    result = _run(tiny(name))
    assert result["correct"] is True
    for check in result["checks"].values():
        assert check["value"] <= 1e-5 and check["value"] < check["limit"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {e["name"] for e in tiny(name).end_to_end}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_per_layer_metrics(tiny, name):
    result = _run(tiny(name), trace=True)
    assert result["correct"] is True
    assert "breakdown" in result and result["device"]["window_s"] > 0
    # the CPU runs no kernel: only the metrics that need none are read
    assert all(m["unit"] == "%" for m in result["metrics"].values())
    assert any(k.startswith("step_mfu") for k in result["metrics"])


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in ("autoint.train", "staytime.train")
    for fault in faults.FAULTS["train"]] + [("staytime.predict", "answer_altered")])
def test_broken_path_is_not_correct(tiny, name, fault):
    cell = tiny(name)
    assert fault in faults.FAULTS[cell.traffic["entry"]]
    with faults.planted(fault, cell.cfg):
        result = _run(cell)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
