"""Tensor parallelism of the port on a 2-D (data 2 x model 2) mesh of 4
gloo ranks, against the JAX package's ``tests/test_tensor_parallel.py``.

ctr (24 slots, attention dropout 0: the packages draw other bits) built
with ``num_shards=2``: the JAX side places a bridged state by
``state_shardings(tensor_parallel=True)`` on a data 2 x model 2 CPU mesh
and takes 3 local steps (XLA inserts the model axis's collectives); the
port's 4 ranks (``torch_sharded_worker.py``) cut their shards by the
port's ``state_shardings(tensor_parallel=True)`` (column shards of 24
kernels) and take 3 sharded steps with ``shardings=``, each rank its data
index's rows.  The state gathered back is held to the JAX one at
``torch_sharded_common``'s tolerances (loss and ``regularization`` rtol
1e-5; params rtol 5e-4, atol 1e-5).  Also: the placements leaf by leaf
against the JAX specs at model 2 and 4 (``dnn_can``'s 82 columns do not
split over 4), the shards' shapes after the steps, the model replicas'
tables bit-equal, and the tensor-parallel predict call and eval step
against the JAX local ones on the whole batch.  One spawn of 4 ranks runs
every case.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import recommendsystem_tpu.train.metrics as JM
from recommendsystem_tpu.core import create_mesh as jax_create_mesh
from recommendsystem_tpu.train import state_shardings as jax_state_shardings
from recommendsystem_tpu.train.step import make_eval_step as jax_make_eval_step
from recommendsystem_tpu.train.step import make_predict_step as jax_make_predict_step
from recommendsystem_tpu_torch.core.mesh import Mesh
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.train import create_train_state, state_shardings
from torch_sharded_common import assert_matches_jax, bridged_case, jax_tp_steps, run_ranks

torch.set_num_threads(1)
DATA, MODEL = 2, 2
KW = dict(bucket_size=128, attention_dropout_rate=0.0)
TOL = dict(rtol=1e-5, atol=2e-6)


SPEC_KINDS = {P(None, "model"): "column", P(): "replicated", P("model", None): "expert",
              P("model", None, None): "expert"}


def _kinds(tree, prefix=""):
    """{param name: "column" | "replicated" | "expert"} of a JAX sharding
    tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_kinds(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = SPEC_KINDS[v.spec]
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    init, rec = {}, {}

    def steps(jbundle, jstate, batches, n, upd):
        init["state"], init["batches"] = jstate, batches
        return jax_tp_steps(jbundle, jstate, batches, n, upd, model=MODEL, record=rec)

    jbundle, jstate, jinfos, case = bridged_case(
        "ctr", KW, DATA, 8 * DATA, seeds=[1, 2, 3], jax_steps=steps,
        model_parallel=MODEL, tensor_parallel=True)
    serve = dict(case, kind="predict", batches=case["batches"][:1])
    cases = [case, serve, dict(serve, kind="eval")]
    results = run_ranks(DATA * MODEL, cases, tmp_path_factory.mktemp("tp"))
    return dict(jbundle=jbundle, jstate=jstate, jinfos=jinfos, init=init, rec=rec,
                results=dict(zip(("train", "predict", "eval"), results)))


def test_three_tp_steps_match_the_jax_tp_steps(group):
    r = group["results"]["train"]
    assert all(i["regularization"] > 0 for i in r["infos"])
    assert_matches_jax(group["jbundle"], group["jstate"], group["jinfos"], r)


@pytest.mark.parametrize("model", [2, 4])
def test_placements_are_the_jax_specs_leaf_by_leaf(group, model):
    mesh = Mesh(group=None, rank=0, size=DATA, device=torch.device("cpu"), model=model)
    bundle = create_model("ctr", device="cpu", num_shards=DATA, **KW)
    pstate = create_train_state(bundle, seed=0)
    got = state_shardings(bundle, pstate, mesh, tensor_parallel=True)
    jstate = group["init"]["state"]
    jmesh = jax_create_mesh(jax.devices()[:DATA * model], model_parallel=model)
    want = jax_state_shardings(group["jbundle"], jstate, jmesh, tensor_parallel=True)
    kinds = _kinds(want.params)
    assert {k: p.kind for k, p in got.params.items()} == kinds
    for moment in ("mu", "nu"):
        assert ({k: p.kind for k, p in got.opt_state[moment].items()}
                == _kinds(getattr(want.opt_state[0], moment)))
    split = sorted(k for k, v in kinds.items() if v == "column")
    assert len(split) == (24 if model == 2 else 23)
    assert ("dnn_can.kernel" in split) == (model == 2)
    assert {p.kind for t in got.tables.values() for p in (t["w"], t["show"])} == {"row"}
    if model == MODEL:
        assert group["results"]["train"]["placements"] == kinds


def test_shards_keep_their_shapes_and_the_replicas_their_bits(group):
    r = group["results"]["train"]
    assert r["replicas_equal"]
    for k, kind in r["placements"].items():
        whole = tuple(r["state"]["params"][k].shape)
        want = whole[:-1] + (whole[-1] // MODEL,) if kind == "column" else whole
        assert r["shard_shapes"][k] == want, k


def _jax_inputs(group):
    (jb, jd, jl, jw), = group["init"]["batches"][:1]
    return group["init"]["state"], jb, jd, jl, jw


def test_tp_predict_call_matches_the_jax_local_one(group):
    jstate, jb, jd, _, _ = _jax_inputs(group)
    want = jax.device_get(jax_make_predict_step(group["jbundle"])(jstate, jb, jd))
    got = group["results"]["predict"]
    assert set(got) == set(want)
    for task, w in want.items():
        np.testing.assert_allclose(torch.cat(got[task]).numpy(), np.asarray(w, np.float32),
                                   **TOL, err_msg=task)


def test_tp_eval_step_matches_the_jax_local_one(group):
    jbundle = group["jbundle"]
    jstate, jb, jd, jl, jw = _jax_inputs(group)
    jstates, _ = jax_make_eval_step(jbundle)(jstate, jb, jl, jw, jd,
                                             JM.init_metrics(jbundle.metrics))
    want = jax.device_get(JM.compute_metrics(jbundle.metrics, jstates))
    got = group["results"]["eval"]
    assert set(got) == set(want)
    for task, ms in want.items():
        for name, v in ms.items():
            np.testing.assert_allclose(got[task][name], float(v), **TOL,
                                       err_msg=f"{task} {name}")
