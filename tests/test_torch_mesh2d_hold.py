"""Phase 17's hold of the 2-D step against the local step
(``chip_smoke._hold_float32`` and ``_hold_policy``), run on the CPU by
``scripts/torch_mesh2d_hold_check.py``: two gloo ranks (data 1 x model 2)
drive phase 17's five cases at their widths over small tables.

- Sound, every case passes, nothing past a tolerance.
- With kinks forced at every step from step 1 (each 2-D ReLU input within
  1e-5 of its call's largest |input| takes the other sign), ctr,
  rough_rank and staytime pass with every step replayed: each entry past
  its tolerance, dense or table, is the local step's with the 2-D step's
  kinks, and none is excused for lying after the first kink.
- A gradient fault of the 2-D step (half of each ReLU's units pass 1.01 of
  their gradient, the values unchanged) is refused.
- Under the bf16 compute policy, a column ``Dense`` that rounds each rank's
  part of x's gradient to bf16 before the sum is refused, and its reading
  lies past the limits that the sound step keeps well inside.

One spawn of two ranks runs every variant.
"""

import os
import sys

import pytest

import chip_smoke as cs

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
from torch_mesh2d_hold_check import VARIANTS, run  # noqa: E402


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run(tmp_path_factory.mktemp("mesh2d_hold"))


@pytest.mark.parametrize("case", VARIANTS["sound"])
def test_the_sound_cases_pass(results, case):
    held = results["sound"][case]
    assert "refused" not in held, held
    if case == "ctr_bf16":
        worst = held["worst_rel"]
        assert worst["loss"] < cs.MESH2D_POLICY_LOSS_RTOL / 5
        assert max(worst["dense"], worst["tables"], worst["update"]) < cs.MESH2D_POLICY_REL_L2 / 5
    else:
        assert held["past"] == 0 and held["replayed_steps"] == []


@pytest.mark.parametrize("case", VARIANTS["kinks"])
def test_kinks_from_step_1_are_explained_by_the_kinked_replay(results, case):
    held = results["kinks"][case]
    assert "refused" not in held, held
    assert held["kinked_step"] == 1 and held["kinked_samples"] > 0
    assert held["replayed_steps"] == [1, 2, 3]
    assert held["kink"] > 0 and held["past"] == held["kink"] + held["rounding"] + \
        held["zero_grad"]


def test_a_gradient_fault_is_refused(results):
    held = results["grad_fault"]["ctr"]
    assert "refused" in held
    assert "with the 2-D step's kinks does not give" in held["refused"]


def test_a_per_rank_rounding_of_the_x_gradient_is_refused(results):
    held = results["rank_rounding"]["ctr_bf16"]
    assert "refused" in held and "relative L2" in held["refused"]
    reading = results["rank_rounding_reading"]["ctr_bf16"]["worst_rel"]
    assert reading["update"] > 2 * cs.MESH2D_POLICY_REL_L2
