"""The port's sharded train step against the JAX package's on 4 gloo
ranks: autoint and ctr, each sparse update, as
``tests/test_torch_sharded_training.py`` runs them on 2."""

import pytest
import torch

from test_torch_sharded_training import MODELS, UPDATES, group
from torch_sharded_common import assert_matches_jax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return group(4, tmp_path_factory)


@pytest.mark.parametrize("update", UPDATES)
@pytest.mark.parametrize("model", list(MODELS))
def test_four_ranks_match_the_jax_sharded_step(four, model, update):
    (jbundle, jstate, jinfos), result = four[(model, update)]
    assert_matches_jax(jbundle, jstate, jinfos, result)
