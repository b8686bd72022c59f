"""Expert parallelism of the port on a model axis of 2 (2 gloo ranks),
against the JAX package.

- The cases of ``tests/test_moe_stacked.py:35-96``: ``MMOEStacked`` with 4
  experts and ``PLEStacked`` (2 shared, 2 x 2 specific experts), each
  bridged from the JAX init; the port's ranks hold half of every stack
  (``nn.expert_shardings``) and run the layer under the model axis
  (``core.model_axis``).  The forward outputs are held to the JAX layer
  at rtol 1e-5, atol 1e-6, and the gradients of x and of every parameter
  (the experts' gathered whole) for random output cotangents to
  ``jax.grad``'s.
- One rough_rank train step with ``stacked_experts=True`` (PLE stacks of 4
  shared and 4 x 2 specific experts in each tower) on a data 1 x model 2
  mesh, its placements ``state_shardings`` merged with
  ``expert_shardings``, held to the JAX local step from the same state on
  a 1 x 2 CPU mesh with the JAX ``expert_shardings`` on its params
  (``torch_sharded_common``'s tolerances); the placements leaf by leaf
  against the JAX specs; the model replicas' tables bit-equal.
- ctr's 3 stacked experts do not split over a model axis of 2:
  ``ValueError``, as the JAX ``device_put`` refuses them.

One spawn of 2 ranks runs every case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from recommendsystem_tpu import nn as jax_nn
from recommendsystem_tpu.core import create_mesh as jax_create_mesh
from recommendsystem_tpu.train import state_shardings as jax_state_shardings
from recommendsystem_tpu.train.step import make_train_step as jax_make_train_step
from recommendsystem_tpu_torch.core.mesh import Mesh
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.nn import expert_shardings
from recommendsystem_tpu_torch.train import create_train_state
from test_torch_autoint_train import _flat
from torch_sharded_common import assert_matches_jax, bridged_case, run_ranks

torch.set_num_threads(1)
M = 2
TOL = dict(rtol=1e-5, atol=1e-6)
LAYERS = {
    "mmoe": (jax_nn.MMOEStacked, dict(num_tasks=2, num_experts=4, expert_dnn_units=(8,)),
             (8, 16)),
    "ple": (jax_nn.PLEStacked, dict(num_tasks=2, num_shared_experts=2,
                                    num_specific_experts=2, expert_dnn_units=(8,)), (8, 12)),
}
ROUGH = dict(user_slots=("1560", "1561", "1562", "1563"), item_slots=("1591", "1592", "1593"),
             bucket_size=64, stacked_experts=True)


def _layer_case(name):
    cls, kw, shape = LAYERS[name]
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal(shape).astype(np.float32)
    layer = cls(**kw)
    params = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    outs = layer.apply({"params": params}, jnp.asarray(x))
    cots = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]

    def loss(p, xx):
        return sum(jnp.sum(o * c) for o, c in zip(layer.apply({"params": p}, xx), cots))

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    want = {"outputs": [np.asarray(o) for o in outs], "x_grad": np.asarray(gx),
            "grads": _flat(gp)}
    case = {"kind": "layer", "layer": name, "model_parallel": M,
            "kwargs": dict(kw, in_features=shape[1]),
            "params": {k: torch.from_numpy(np.array(v)) for k, v in _flat(params).items()},
            "x": torch.from_numpy(x), "cotangents": [torch.from_numpy(c) for c in cots]}
    return want, case


def _jax_ep_steps(jbundle, jstate, batches, n, sparse_update, record):
    """The JAX local step on a data 1 x model 2 CPU mesh, the params placed
    by the JAX ``expert_shardings`` (the rest by ``state_shardings``)."""
    mesh = jax_create_mesh(jax.devices()[:M], model_parallel=M)
    sh = jax_state_shardings(jbundle, jstate, mesh)
    sh.params = jax_nn.expert_shardings(jstate.params, mesh)
    record["shardings"] = sh.params
    state = jax.device_put(jstate, sh)
    data = NamedSharding(mesh, P("data"))
    put = lambda x: None if x is None else jax.device_put(  # noqa: E731
        x, jax.tree.map(lambda _: data, x))
    step = jax_make_train_step(jbundle, donate=False, sparse_update=sparse_update)
    infos = []
    for i, (b, d, l, w) in enumerate(batches):
        state, info = step(state, put(b), put(l), put(w), put(d), jax.random.PRNGKey(i))
        infos.append({k: float(v) for k, v in jax.device_get(info).items()})
    return state, infos


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    wants, cases = {}, []
    for name in LAYERS:
        wants[name], case = _layer_case(name)
        cases.append(case)
    rec = {}
    jbundle, jstate, jinfos, case = bridged_case(
        "rough_rank", ROUGH, 1, 16, seeds=[3],
        jax_steps=lambda jb, js, bs, n, upd: _jax_ep_steps(jb, js, bs, n, upd, rec),
        model_parallel=M, experts=True)
    cases.append(case)
    results = run_ranks(M, cases, tmp_path_factory.mktemp("ep"))
    return wants, dict(zip(list(LAYERS) + ["rough_rank"], results)), (jbundle, jstate,
                                                                     jinfos, rec)


@pytest.mark.parametrize("name", list(LAYERS))
def test_split_stack_matches_the_jax_layer_forward_and_backward(group, name):
    wants, results, _ = group
    want, got = wants[name], results[name]
    assert {k for k, v in got["kinds"].items() if v == "expert"} == {
        k for k in want["grads"] if "experts." in k}
    for o, w in zip(got["outputs"], want["outputs"]):
        np.testing.assert_allclose(o.numpy(), w, **TOL)
    np.testing.assert_allclose(got["x_grad"].numpy(), want["x_grad"], **TOL)
    assert set(got["grads"]) == set(want["grads"])
    for k, w in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k].numpy(), w, **TOL, err_msg=k)


def test_rough_rank_expert_parallel_step_matches_the_jax_step(group):
    _, results, (jbundle, jstate, jinfos, _) = group
    r = results["rough_rank"]
    assert r["replicas_equal"]
    assert_matches_jax(jbundle, jstate, jinfos, r)
    for k, kind in r["placements"].items():
        whole = tuple(r["state"]["params"][k].shape)
        assert r["shard_shapes"][k] == ((whole[0] // M,) + whole[1:] if kind == "expert"
                                        else whole), k


def test_expert_placements_are_the_jax_specs_leaf_by_leaf(group):
    _, results, (_, _, _, rec) = group
    want = {k: "expert" if v.spec and v.spec[0] == "model" else "replicated"
            for k, v in _flat_specs(rec["shardings"]).items()}
    got = results["rough_rank"]["placements"]
    assert got == want
    assert sorted(k for k, v in got.items() if v == "expert") == sorted(
        f"sub_model_{t}.ple.{s}.{p}" for t in ("user", "item")
        for s in ("experts", "specific_experts") for p in ("kernel0", "bias0"))


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_three_experts_do_not_split_over_two():
    bundle = create_model("ctr", device="cpu", bucket_size=64, stacked_experts=True)
    params = create_train_state(bundle, seed=0).params
    mesh = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"), model=M)
    with pytest.raises(ValueError, match="3 experts do not split"):
        expert_shardings(params, mesh)
    one = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"), model=1)
    kinds = {k: p.kind for k, p in expert_shardings(params, one).items()}
    assert {k for k, v in kinds.items() if v == "expert"} == {
        k for k, v in params.items() if k.startswith("experts.") and v.ndim >= 2}
