"""On the card, at each cell's own sizes: the control (the reference
computed in TF32 in the program's place) fails a number of the cell on
three seeds, and a sound run of the program passes every one.  Skips
without a card, and the four-card cell without four."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT
from harness import cells

CELLS = ["autoint.train", "staytime.train", "staytime.predict"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    import calibrate

    cell = cells.load(name)
    limits = cell.limits()
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        numbers = calibrate.readings(cell, seed, card, "control")
        assert any(numbers[k] > lim for k, lim in limits.items()), numbers
    numbers = calibrate.readings(cell, 2 ** 31 + 4, card, "sound")
    assert all(numbers[k] <= lim for k, lim in limits.items()), numbers


@pytest.mark.cuda
def test_four_card_control_fails_and_program_passes(card):
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    name = "autoint.train.dp4"
    out = subprocess.run([sys.executable, os.path.join(BENCH, "calibrate.py"), "--workload", name,
                          "--seeds", str(2 ** 31 + 4),
                          "--control-seeds", ",".join(str(2 ** 31 + i) for i in (1, 2, 3))],
                         capture_output=True, text=True, timeout=1800, cwd=ROOT, check=True)
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith('{"kind"')]
    limits = cells.load(name).limits()
    assert [x["kind"] for x in lines] == ["sound"] + ["control"] * 3
    for x in lines:
        failed = any(x["numbers"][k] > lim for k, lim in limits.items())
        assert failed == (x["kind"] == "control"), x
