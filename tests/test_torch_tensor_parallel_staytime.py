"""Tensor parallelism of staytime on a data 2 x model 2 mesh of 4 gloo
ranks, against the JAX package's TP steps.

Staytime at the 16-slot configuration of ``tests/test_torch_staytime_serving.py``
(three behaviour sequences, 5 ids a column, SparseAdaGrad: K9's path),
built with ``num_shards=2`` and placed by both packages'
``state_shardings(tensor_parallel=True, tp_min_dim=8)``:

- 3 port steps against 3 JAX TP steps (``test_torch_tensor_parallel_models.
  assert_tp_result``: the gathered state at ``torch_sharded_common``'s
  tolerances, the placements leaf by leaf, the shards, the replicas).  The
  three DIN scorers' ``b2`` have a gradient of 0 in exact arithmetic, so
  each package's Adam moves them by its own rounding noise: an entry of
  one past the tolerance passes only where both first moments of it are
  within 1e-9 of 0, as ``tests/test_torch_staytime_train.py`` holds them;
- the same with ``stacked_experts=True``: the PPNet-gated experts stacked
  three deep, whose (3, out) biases split by columns while no layer reads
  them as column shards, so the step gathers them whole (``gather_leaf``);
- staytime's predict call and eval step under the placements against the
  JAX local ones on the whole batch (rtol 1e-5, atol 2e-6): K7 gathering
  its facts from the exchanged rows under a model axis.

One spawn of 4 ranks runs every case.
"""

import jax
import numpy as np
import pytest
import torch

import recommendsystem_tpu.train.metrics as JM
from recommendsystem_tpu.models.staytime import StaytimeConfig as JaxStaytimeConfig
from recommendsystem_tpu.train.step import make_eval_step as jax_make_eval_step
from recommendsystem_tpu.train.step import make_predict_step as jax_make_predict_step
from recommendsystem_tpu_torch.core.mesh import Mesh
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
from recommendsystem_tpu_torch.train import create_train_state, state_shardings
from recommendsystem_tpu_torch.train.step import _model_axis
from test_torch_staytime_serving import CFG16, HIDDEN
from test_torch_tensor_parallel_models import DATA, MODEL, TP_MIN, assert_tp_result, tp_case
from torch_sharded_common import run_ranks

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)
KW = dict(cfg=StaytimeConfig(**CFG16), deep_hidden_units=HIDDEN)
JKW = dict(cfg=JaxStaytimeConfig(**CFG16), deep_hidden_units=HIDDEN)
CASES = {"staytime": {}, "stacked": {"stacked_experts": True}}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    expected, cases = {}, []
    for name, extra in CASES.items():
        *want, case, rec = tp_case("staytime", {**KW, **extra}, {**JKW, **extra})
        expected[name] = (*want, rec)
        cases.append(case)
    serve = dict(cases[0], kind="predict", batches=cases[0]["batches"][:1])
    cases += [serve, dict(serve, kind="eval")]
    results = run_ranks(DATA * MODEL, cases, tmp_path_factory.mktemp("tp_staytime"))
    return expected, dict(zip(list(CASES) + ["predict", "eval"], results))


@pytest.mark.parametrize("name", list(CASES))
def test_three_tp_steps_match_the_jax_tp_steps(group, name):
    expected, results = group
    jbundle, jstate, jinfos, rec = expected[name]
    # the DIN scorers' b2: a gradient of 0 in exact arithmetic
    b2 = {k for k in results[name]["placements"] if k.startswith("din_") and k.endswith(".b2")}
    assert len(b2) == 3
    assert_tp_result(jbundle, jstate, jinfos, results[name], rec, zero_grad=b2)


def test_stacked_biases_go_through_gather_leaf(group):
    """The stacked experts' (3, out) biases split by columns, their (3, in,
    out) kernels stay whole, and the step gathers the biases whole: no
    layer reads them as column shards."""
    _, results = group
    placements = results["stacked"]["placements"]
    bundle = create_model("staytime", device="cpu", num_shards=DATA, stacked_experts=True, **KW)
    mesh = Mesh(group=None, rank=0, size=DATA, device=torch.device("cpu"), model=MODEL)
    sh = state_shardings(bundle, create_train_state(bundle, seed=0), mesh,
                         tensor_parallel=True, tp_min_dim=TP_MIN)
    assert {k: p.kind for k, p in sh.params.items()} == placements
    gathered = set(_model_axis(bundle, mesh, sh).gather)
    stacked = {k for k, v in placements.items()
               if v == "column" and k.startswith("experts.") and k.endswith(".bias")}
    assert len(stacked) == 6
    assert stacked <= gathered
    assert all(placements[k[:-len("bias")] + "kernel"] == "replicated" for k in stacked)


def _jax_inputs(expected):
    jbundle, _, _, rec = expected["staytime"]
    (jb, jd, jl, jw), = rec["batches"][:1]
    return jbundle, rec["state"], jb, jd, jl, jw


def test_tp_predict_call_matches_the_jax_local_one(group):
    expected, results = group
    jbundle, jstate, jb, jd, _, _ = _jax_inputs(expected)
    want = jax.device_get(jax_make_predict_step(jbundle)(jstate, jb, jd))
    got = results["predict"]
    assert set(got) == set(want)
    for task, w in want.items():
        np.testing.assert_allclose(torch.cat(got[task]).numpy(), np.asarray(w, np.float32),
                                   **TOL, err_msg=task)


def test_tp_eval_step_matches_the_jax_local_one(group):
    expected, results = group
    jbundle, jstate, jb, jd, jl, jw = _jax_inputs(expected)
    jstates, _ = jax_make_eval_step(jbundle)(jstate, jb, jl, jw, jd,
                                             JM.init_metrics(jbundle.metrics))
    want = jax.device_get(JM.compute_metrics(jbundle.metrics, jstates))
    got = results["eval"]
    assert set(got) == set(want)
    for task, ms in want.items():
        for name, v in ms.items():
            np.testing.assert_allclose(got[task][name], float(v), **TOL,
                                       err_msg=f"{task} {name}")
