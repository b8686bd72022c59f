"""The port's sharded packed step on staytime, multi_head, finish and
rough_rank against the JAX package's, and the sharded predict and eval
steps of staytime against the port's local ones.

One group of 2 gloo ranks (``torch_sharded_worker.py``) runs every case:
one packed step of each model from a bridged JAX state, held to the JAX
sharded step at ``torch_sharded_common``'s tolerances (staytime: SparseAdaGrad
over 16 slots with three behaviour sequences, 5 ids a column; the JAX
multi_head's InteractingLayer applied with ``training=False`` and the port
layer's ``use_dropout`` off, as ``tests/test_torch_multi_head_train.py``
does); then staytime's sharded predict call (K7 gathering its facts from
the rows that the exchange brought, by position) and eval step (the metric
increments summed over the ranks), held to the local steps on the whole
batch at rtol 1e-5, atol 2e-6; and, within the port, one scatter and one
dense sharded step of each of the four models against the local step on
the whole batch (``torch_sharded_common``'s tolerances).
"""

import numpy as np
import pytest
import torch

import recommendsystem_tpu.nn as jax_nn
from recommendsystem_tpu.models.staytime import StaytimeConfig as JaxStaytimeConfig
from recommendsystem_tpu_torch.core.mesh import Mesh
from recommendsystem_tpu_torch.embedding.engine import IdBatch
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.train import metrics as M
from recommendsystem_tpu_torch.train import create_train_state, make_eval_step, make_predict_step
from recommendsystem_tpu_torch.train.state import TrainState
from test_torch_multi_head_train import _EvalInteractingLayer
from test_torch_staytime_serving import CFG16, HIDDEN
from torch_sharded_common import (PARAM_TOL, TABLE_TOL, assert_matches_jax, bridged_case,
                                  port_batch, run_ranks)

torch.set_num_threads(1)
N = 2
TOL = dict(rtol=1e-5, atol=2e-6)
STAYTIME = (dict(cfg=StaytimeConfig(**CFG16), deep_hidden_units=HIDDEN),
            dict(cfg=JaxStaytimeConfig(**CFG16), deep_hidden_units=HIDDEN))
MODELS = {
    "staytime": STAYTIME,
    "multi_head": (dict(slots=tuple(str(2000 + i) for i in range(6)), bucket_size=64), None),
    "finish": (dict(slots=tuple(str(3000 + i) for i in range(12)),
                    bias_slots=tuple(str(3000 + i) for i in range(4)), bucket_size=64), None),
    "rough_rank": (dict(user_slots=("1560", "1561", "1562", "1563"),
                        item_slots=("1591", "1592", "1593"), bucket_size=64), None),
}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_nn, "InteractingLayer", _EvalInteractingLayer)
    try:
        expected, cases = {}, []
        for model, (kw, jkw) in MODELS.items():
            jbundle, jstate, jinfos, case = bridged_case(
                model, kw, N, 8 * N, seeds=[3], jkw=jkw, no_dropout=model == "multi_head")
            expected[model] = (jbundle, jstate, jinfos)
            cases.append(case)
    finally:
        mp.undo()
    serve = dict(cases[0], kind="predict")
    cases += [serve, dict(serve, kind="eval")]
    names = list(MODELS) + ["predict", "eval"]
    for model, (kw, _) in MODELS.items():
        for upd in CLASSIC:
            cases.append(_local_case(model, kw, upd))
            names.append((model, upd))
    results = run_ranks(N, cases, tmp_path_factory.mktemp("models"))
    return expected, dict(zip(names, results)), serve


CLASSIC = ("scatter", "dense")


def _local_case(model, kw, update):
    """A port-only case: one sharded step of ``update`` and the local step
    on the whole batch, from one ``create_train_state``."""
    bundle = create_model(model, device="cpu", num_shards=N, **kw)
    st = create_train_state(bundle, seed=0)
    return {"kind": "train", "model": model, "kwargs": kw, "sparse_update": update,
            "state": {"params": st.params, "opt_state": st.opt_state, "tables": st.tables,
                      "step": 0},
            "batches": [port_batch(*synthetic_batch(bundle, 8 * N, seed=7))], "seeds": [9],
            "local": True}


@pytest.mark.parametrize("model", list(MODELS))
def test_one_packed_step_matches_the_jax_sharded_step(group, model):
    expected, results, _ = group
    assert_matches_jax(*expected[model], results[model])


def _local(serve):
    bundle = create_model("staytime", device="cpu", num_shards=N, **serve["kwargs"])
    st = serve["state"]
    state = TrainState(params=st["params"], opt_state=st["opt_state"], tables=st["tables"],
                       step=0)
    item = serve["batches"][0]
    batch = {k: IdBatch(rows=r, mask=m) for k, (r, m) in item["batch"].items()}
    return bundle, state, batch, item


def test_sharded_predict_call_matches_the_local_one(group):
    _, results, serve = group
    bundle, state, batch, item = _local(serve)
    want = make_predict_step(bundle)(state, batch, item["dense"])
    got = results["predict"]
    assert set(got) == set(want)
    for task, w in want.items():
        np.testing.assert_allclose(torch.cat(got[task]).numpy(), w.float().numpy(), **TOL,
                                   err_msg=task)


def test_sharded_eval_step_sums_the_ranks_metrics(group):
    _, results, serve = group
    bundle, state, batch, item = _local(serve)
    states = M.init_metrics(bundle.metrics, "cpu")
    states, _ = make_eval_step(bundle)(state, batch, item["labels"], item["weight"],
                                       item["dense"], states)
    want = M.compute_metrics(bundle.metrics, states)
    got = results["eval"]
    assert set(got) == set(want)
    for task, ms in want.items():
        for name, v in ms.items():
            np.testing.assert_allclose(got[task][name], float(v), **TOL,
                                       err_msg=f"{task} {name}")


def test_sharded_steps_need_a_mesh():
    bundle = create_model("staytime", device="cpu", **STAYTIME[0])
    with pytest.raises(ValueError, match="needs a mesh"):
        make_predict_step(bundle, mode="sharded")
    with pytest.raises(ValueError, match="needs a mesh"):
        make_eval_step(bundle, mode="sharded")
    with pytest.raises(ValueError, match="mode .pipeline."):
        make_eval_step(bundle, mode="pipeline", mesh=Mesh(None, 0, 1, torch.device("cpu")))


@pytest.mark.parametrize("update", CLASSIC)
@pytest.mark.parametrize("model", list(MODELS))
def test_classic_sharded_steps_equal_the_local_step(group, model, update):
    _, results, _ = group
    r = results[(model, update)]
    np.testing.assert_allclose(r["infos"][0]["loss"], r["local_infos"][0]["loss"], rtol=1e-5)
    sh, lo = r["state"], r["local_state"]
    for k, v in lo["params"].items():
        np.testing.assert_allclose(sh["params"][k].numpy(), v.numpy(), **PARAM_TOL, err_msg=k)
    for skey, t in lo["tables"].items():
        got = sh["tables"][skey]
        np.testing.assert_allclose(got["w"].float().numpy(), t["w"].float().numpy(),
                                   **TABLE_TOL, err_msg=skey)
        np.testing.assert_array_equal(got["show"].numpy(), t["show"].numpy(), err_msg=skey)
        for name, v in t["opt"].items():
            np.testing.assert_allclose(got["opt"][name].float().numpy(), v.float().numpy(),
                                       **TABLE_TOL, err_msg=f"{skey} {name}")
