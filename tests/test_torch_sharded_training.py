"""The port's sharded train step against the JAX package's, autoint and
ctr on 2 ranks (``tests/test_torch_sharded_four_ranks.py``: on 4).

``make_train_step(bundle, mode="sharded", mesh=m)`` runs on n gloo ranks
(``torch_sharded_worker.py``), each with its row shards of the bridged
JAX state and its rows of the batch, for each sparse update (packed,
scatter, dense), two steps; the state gathered back is held to the JAX
sharded step on ``create_mesh(jax.devices()[:n])`` from the same state
(``torch_sharded_common.assert_matches_jax``).  Attention dropout is off
on both sides (the packages draw other bits).  One spawned group of n
ranks runs every case of its n.
"""

import pytest
import torch

from torch_sharded_common import NO_DROPOUT, assert_matches_jax, bridged_case, run_ranks

torch.set_num_threads(1)
UPDATES = ("packed", "scatter", "dense")
MODELS = {"autoint": dict(bucket_size=64, model_param=NO_DROPOUT),
          "ctr": dict(bucket_size=128, attention_dropout_rate=0.0)}


def group(n, tmp_path_factory):
    expected, cases = [], []
    for model, kw in MODELS.items():
        for upd in UPDATES:
            jbundle, jstate, jinfos, case = bridged_case(model, kw, n, 8 * n, seeds=[1, 2],
                                                         sparse_update=upd)
            expected.append((jbundle, jstate, jinfos))
            cases.append(case)
    results = run_ranks(n, cases, tmp_path_factory.mktemp(f"sharded{n}"))
    keys = [(m, u) for m in MODELS for u in UPDATES]
    return {k: (e, r) for k, e, r in zip(keys, expected, results)}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return group(2, tmp_path_factory)


@pytest.mark.parametrize("update", UPDATES)
@pytest.mark.parametrize("model", list(MODELS))
def test_two_ranks_match_the_jax_sharded_step(two, model, update):
    (jbundle, jstate, jinfos), result = two[(model, update)]
    assert_matches_jax(jbundle, jstate, jinfos, result)
