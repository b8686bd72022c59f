"""Tensor parallelism of the port on finish, multi_head, rough_rank and
autoint: 3 steps on a data 2 x model 2 mesh of 4 gloo ranks against the
JAX package's TP steps (staytime and the 212-feature ctr have files of
their own, ctr ``test_torch_tensor_parallel.py``).

Each model is built at small widths with ``num_shards=2`` and placed by
both packages' ``state_shardings(tensor_parallel=True, tp_min_dim=8)``
(at the default 64 nothing of these widths splits): finish, multi_head
(the JAX InteractingLayer applied with ``training=False`` and the port
layer's ``use_dropout`` off, as ``tests/test_torch_multi_head_train.py``
does), rough_rank with its unstacked PLE and autoint (dropout off).  The JAX side
takes 3 local steps on the placed state (XLA inserts the model axis's
collectives, ``torch_sharded_common.jax_tp_steps``); the port's ranks
(``torch_sharded_worker.py``) take 3 sharded steps with ``shardings=``.
The state gathered back is held to the JAX one at ``torch_sharded_common``'s
tolerances (loss and ``regularization`` rtol 1e-5; params rtol 5e-4, atol
1e-5; tables per ``TABLE_TOL``), each rank's placements to the JAX specs
leaf by leaf, the shards' shapes after the steps to the placements, and
the model replicas' tables bit for bit.  One spawn of 4 ranks runs every
case.
"""

import jax
import pytest
import torch

import recommendsystem_tpu.nn as jax_nn
from test_torch_multi_head_train import _EvalInteractingLayer
from test_torch_tensor_parallel import _kinds
from torch_sharded_common import (NO_DROPOUT, assert_matches_jax, bridged_case, jax_tp_steps,
                                  run_ranks)

torch.set_num_threads(1)
DATA, MODEL = 2, 2
TP_MIN = 8
CTR212 = dict(bucket_size=64, attention_dropout_rate=0.0)
# name: (model, port kwargs, JAX kwargs where they differ, ids a column)
MODELS = {
    "finish": ("finish", dict(slots=tuple(str(3000 + i) for i in range(12)),
                              bias_slots=tuple(str(3000 + i) for i in range(4)),
                              bucket_size=64), None, 5),
    "multi_head": ("multi_head", dict(slots=tuple(str(2000 + i) for i in range(6)),
                                      bucket_size=64), None, 5),
    "rough_rank": ("rough_rank", dict(user_slots=("1560", "1561", "1562", "1563"),
                                      item_slots=("1591", "1592", "1593"), bucket_size=64),
                   None, 5),
    "autoint": ("autoint", dict(bucket_size=64, model_param=NO_DROPOUT), None, 5),
}


def tp_case(model, kw, jkw=None, ids_per_feature=5, seeds=(1, 2, 3), tp_min_dim=TP_MIN,
            jax_steps=jax_tp_steps, **extra):
    """(JAX bundle, JAX state after the JAX steps, JAX infos, the port's
    case, the record: the JAX placements, the initial state and batches):
    one bridged case on data 2 x model 2 at ``tp_min_dim``, the JAX side
    by ``jax_steps`` (the JAX TP steps)."""
    rec = {}

    def steps(jbundle, jstate, batches, n, upd):
        rec["state"], rec["batches"] = jstate, batches
        return jax_steps(jbundle, jstate, batches, n, upd, model=MODEL, record=rec,
                         tp_min_dim=tp_min_dim)

    jbundle, jstate, jinfos, case = bridged_case(
        model, kw, DATA, 8 * DATA, seeds=list(seeds), jkw=jkw, jax_steps=steps,
        ids_per_feature=ids_per_feature, model_parallel=MODEL, tensor_parallel=True,
        tp_min_dim=tp_min_dim, **extra)
    return jbundle, jstate, jinfos, case, rec


def assert_tp_result(jbundle, jstate, jinfos, result, rec, zero_grad=()):
    """The port's TP steps against the JAX ones: the gathered state and
    infos (``zero_grad`` as ``assert_matches_jax`` takes it), the
    placements leaf by leaf (at least one column), the shards' shapes, the
    replicas' tables."""
    assert_matches_jax(jbundle, jstate, jinfos, result, zero_grad)
    kinds = _kinds(rec["shardings"].params)
    assert result["placements"] == kinds
    assert "column" in kinds.values()
    assert result["replicas_equal"]
    for k, kind in kinds.items():
        whole = tuple(result["state"]["params"][k].shape)
        want = whole[:-1] + (whole[-1] // MODEL,) if kind == "column" else whole
        assert result["shard_shapes"][k] == want, k


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    expected, cases = {}, []
    for name, (model, kw, jkw, ipf) in MODELS.items():
        with pytest.MonkeyPatch.context() as mp:
            if name == "multi_head":
                mp.setattr(jax_nn, "InteractingLayer", _EvalInteractingLayer)
            *want, case, rec = tp_case(model, kw, jkw, ipf, no_dropout=name == "multi_head")
        expected[name] = (*want, rec)
        cases.append(case)
    results = run_ranks(DATA * MODEL, cases, tmp_path_factory.mktemp("tp_models"))
    return expected, dict(zip(MODELS, results))


@pytest.mark.parametrize("name", list(MODELS))
def test_three_tp_steps_match_the_jax_tp_steps(group, name):
    expected, results = group
    jbundle, jstate, jinfos, rec = expected[name]
    assert_tp_result(jbundle, jstate, jinfos, results[name], rec)
    assert jax.tree.leaves(rec["state"].params)
