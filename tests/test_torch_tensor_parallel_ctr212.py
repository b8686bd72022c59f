"""Tensor parallelism of the 212-feature ctr
(``synthetic_ctr_config(num_slots=180, num_bias=32)``: one id a column,
56-wide rows, K2's and K4's path; attention dropout 0) on a data 2 x
model 2 mesh of 4 gloo ranks.

Both packages place the state by ``state_shardings(tensor_parallel=True,
tp_min_dim=8)``, and the port's ranks take 3 sharded steps with
``shardings=`` (``torch_sharded_worker.py``).  Their state gathered back is
held at ``torch_sharded_common``'s tolerances to 3 JAX local steps on the
whole batch from the same state: XLA takes ~13 minutes to compile the JAX
TP step of this configuration on a CPU (its "very slow compile" warning),
which no test here can wait for, and the TP step computes the local
step's function (XLA only inserts the model axis's collectives), as
``test_torch_tensor_parallel_models.py`` holds for the other models.  The
port's placements are held to the JAX TP placements of this state leaf by
leaf, here and at full width
(``test_torch_tensor_parallel_placements.py``).  One spawn of 4 ranks.
"""

import jax
import pytest
import torch

from recommendsystem_tpu.core import create_mesh as jax_create_mesh
from recommendsystem_tpu.core.config import synthetic_ctr_config as jax_synthetic_ctr_config
from recommendsystem_tpu.train import state_shardings as jax_state_shardings
from recommendsystem_tpu.train.step import make_train_step as jax_make_train_step
from recommendsystem_tpu_torch.core.config import synthetic_ctr_config
from test_torch_tensor_parallel_models import DATA, MODEL, assert_tp_result, tp_case
from torch_sharded_common import run_ranks

torch.set_num_threads(1)
KW = dict(bucket_size=64, attention_dropout_rate=0.0)


def jax_local_steps(jbundle, jstate, batches, n, upd, model, record, tp_min_dim):
    """The JAX local step a batch on the whole batch (step i keyed
    ``PRNGKey(i)``); ``record`` gets the JAX TP placements of the state."""
    mesh = jax_create_mesh(jax.devices()[:n * model], model_parallel=model)
    record["shardings"] = jax_state_shardings(jbundle, jstate, mesh, tensor_parallel=True,
                                              tp_min_dim=tp_min_dim)
    step = jax_make_train_step(jbundle, donate=False, sparse_update=upd)
    infos = []
    for i, (b, d, l, w) in enumerate(batches):
        jstate, info = step(jstate, b, l, w, d, jax.random.PRNGKey(i))
        infos.append({k: float(v) for k, v in jax.device_get(info).items()})
    return jstate, infos


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    *want, case, rec = tp_case(
        "ctr", dict(KW, cfg=synthetic_ctr_config(num_slots=180, num_bias=32)),
        dict(KW, cfg=jax_synthetic_ctr_config(num_slots=180, num_bias=32)), ids_per_feature={},
        jax_steps=jax_local_steps)
    result, = run_ranks(DATA * MODEL, [case], tmp_path_factory.mktemp("tp_ctr212"))
    return (*want, rec), result, case


def test_three_tp_steps_match_the_jax_steps(group):
    (jbundle, jstate, jinfos, rec), result, case = group
    assert all(v["batch"][k][0].shape[1] == 1 for v in case["batches"] for k in v["batch"])
    assert sum(k.startswith("emb_linear_map_") for k in result["placements"]) == 2 * 180
    assert_tp_result(jbundle, jstate, jinfos, result, rec)
