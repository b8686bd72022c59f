"""On the card, at each one-card cell's own sizes: the control (the
reference computed in TF32 in the program's place) fails a number of the
cell on three seeds, and a sound run of the program passes every one.
Skips without a card."""

from __future__ import annotations

import pytest

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
