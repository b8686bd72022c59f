"""The 2-D mesh's placements of every model at full width, against the JAX
rule leaf by leaf.

``train.state.state_shardings(..., tensor_parallel=True, tp_min_dim=64)``
gives a ``"column"`` placement to every 2-D param whose last dim is at
least 64 and divides by the model axis, and to its Adam ``mu`` and ``nu``
(``recommendsystem_tpu/train/state.py:59-63``).  The rule reads only
shapes, so both sides are built without tables: the JAX state by
``jax.eval_shape`` of its init, the port's by its module's parameters
and their Adam state.  At a model axis of 2 the JAX rule splits 22 leaves
of staytime, 25 of the 212-feature ctr
(``synthetic_ctr_config(num_slots=180, num_bias=32)``), 24 of ctr, 3 of
finish, 2 of rough_rank and none of autoint or multi_head; with
``stacked_experts=True`` 10 of staytime (six of them the stacked experts'
(3, out) biases) and 12 of ctr; the port's placements equal them leaf by leaf, for
each model and each ``stacked_experts=True`` variant.

``nn.expert_shardings`` against the JAX ``expert_shardings``
(``recommendsystem_tpu/nn/moe_stacked.py:145-163``, which splits the
leaves under an ``experts`` or ``specific_experts`` key): rough_rank's PLE
stacks split, multi_head's ``experts_fc1`` stack stays whole, and the
three experts of ctr and staytime do not split over 2, which the port
refuses with ``ValueError`` as the JAX ``device_put`` refuses their
placement.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from recommendsystem_tpu import nn as jax_nn
from recommendsystem_tpu.core import create_mesh as jax_create_mesh
from recommendsystem_tpu.core.config import synthetic_ctr_config as jax_synthetic_ctr_config
from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train import state_shardings as jax_state_shardings
from recommendsystem_tpu_torch.core.config import synthetic_ctr_config
from recommendsystem_tpu_torch.core.mesh import Mesh
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.nn import expert_shardings
from recommendsystem_tpu_torch.train import TrainState, state_shardings
from test_torch_tensor_parallel import _kinds

torch.set_num_threads(1)
DATA, MODEL = 2, 2
# name: (model, port kwargs, JAX kwargs, column leaves at tp_min_dim 64)
MODELS = {
    "autoint": ("autoint", {}, {}, 0),
    "multi_head": ("multi_head", {}, {}, 0),
    "finish": ("finish", {}, {}, 3),
    "staytime": ("staytime", {}, {}, 22),
    "rough_rank": ("rough_rank", {}, {}, 2),
    "ctr": ("ctr", {}, {}, 24),
    "ctr212": ("ctr", {"cfg": synthetic_ctr_config(num_slots=180, num_bias=32)},
               {"cfg": jax_synthetic_ctr_config(num_slots=180, num_bias=32)}, 25),
}
STACKED = {"ctr": 12, "multi_head": 0, "staytime": 10, "rough_rank": 2}


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


def _jax_state(model, jkw):
    """The JAX bundle and its state's shapes (``jax.eval_shape``: no table
    is allocated)."""
    jbundle = jax_create_model(model, **jkw)
    jb, jd, _, _ = jax_synthetic_batch(jbundle, 8, seed=0)
    return jbundle, jax.eval_shape(
        lambda: jax_create_train_state(jbundle, jax.random.PRNGKey(0), jb, dense_inputs=jd))


def _port_state(model, kw):
    """The port's bundle and a state of its dense params and their Adam
    state, with no tables."""
    bundle = create_model(model, device="cpu", **kw)
    params = {k: v.detach() for k, v in bundle.module.named_parameters()}
    return bundle, TrainState(params=params, opt_state=bundle.dense_optimizer.init(params),
                              tables={}, step=0)


def _port_mesh():
    return Mesh(group=None, rank=0, size=DATA, device=torch.device("cpu"), model=MODEL)


def _jax_mesh():
    return jax_create_mesh(jax.devices()[:DATA * MODEL], model_parallel=MODEL)


def _assert_tp_placements(model, kw, jkw, n_columns):
    jbundle, jstate = _jax_state(model, jkw)
    want = jax_state_shardings(jbundle, jstate, _jax_mesh(), tensor_parallel=True,
                               tp_min_dim=64)
    bundle, pstate = _port_state(model, kw)
    got = state_shardings(bundle, pstate, _port_mesh(), tensor_parallel=True, tp_min_dim=64)
    kinds = _kinds(want.params)
    assert {k: p.kind for k, p in got.params.items()} == kinds
    for moment in ("mu", "nu"):
        assert ({k: p.kind for k, p in got.opt_state[moment].items()}
                == _kinds(getattr(want.opt_state[0], moment)))
    assert sum(v == "column" for v in kinds.values()) == n_columns
    return kinds, _shapes(jstate.params)


@pytest.mark.parametrize("name", list(MODELS))
def test_tp_placements_are_the_jax_rule_at_full_width(name):
    model, kw, jkw, n = MODELS[name]
    _assert_tp_placements(model, kw, jkw, n)


@pytest.mark.parametrize("model", list(STACKED))
def test_stacked_tp_placements_are_the_jax_rule_at_full_width(model):
    kinds, shapes = _assert_tp_placements(model, {"stacked_experts": True},
                                          {"stacked_experts": True}, STACKED[model])
    if model == "staytime":
        biases = [k for k, v in kinds.items() if v == "column" and k.startswith("experts.")]
        assert len(biases) == 6
        assert all(k.endswith(".bias") and shapes[k][0] == 3 for k in biases)


@pytest.mark.parametrize("model", ["multi_head", "rough_rank"])
def test_expert_placements_are_the_jax_specs(model):
    _, jstate = _jax_state(model, {"stacked_experts": True})
    want = _kinds(jax_nn.expert_shardings(jstate.params, _jax_mesh()))
    bundle, pstate = _port_state(model, {"stacked_experts": True})
    got = expert_shardings(pstate.params, _port_mesh())
    assert {k: p.kind for k, p in got.items()} == want
    split = {k for k, v in want.items() if v == "expert"}
    if model == "multi_head":
        assert not split and _shapes(jstate.params)["experts_fc1.kernel"] == (8, 336, 32)
    else:
        assert len(split) == 8


@pytest.mark.parametrize("model", ["ctr", "staytime"])
def test_three_experts_do_not_split_over_two(model):
    _, jstate = _jax_state(model, {"stacked_experts": True})
    jmesh = _jax_mesh()
    want = _kinds(jax_nn.expert_shardings(jstate.params, jmesh))
    shapes = _shapes(jstate.params)
    split = [k for k, v in want.items() if v == "expert"]
    assert len(split) == 12 and {shapes[k][0] for k in split} == {3}
    bias = next(k for k in split if k.endswith(".bias"))
    with pytest.raises(ValueError):
        jax.device_put(jnp.zeros(shapes[bias]), NamedSharding(jmesh, P("model", None)))
    _, pstate = _port_state(model, {"stacked_experts": True})
    with pytest.raises(ValueError, match="3 experts do not split over a model axis of 2"):
        expert_shardings(pstate.params, _port_mesh())
