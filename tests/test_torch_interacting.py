"""Port parity: InteractingLayer and MultiLayerDense against flax, with the
flax parameters carried across unchanged (same names, (in, out) layout).

Tolerance rtol 1e-5, atol 2e-6: float32 products summed in another order by
XLA-CPU and torch."""

import jax
import numpy as np
import pytest
import torch
from torch.func import functional_call

from recommendsystem_tpu import nn as jnn
from recommendsystem_tpu_torch.bridge import _flatten
from recommendsystem_tpu_torch.nn import InteractingLayer, MultiLayerDense
from recommendsystem_tpu_torch.nn.mlp import glorot_uniform_

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)


def _torch_params(flax_params):
    return {k: torch.from_numpy(np.array(v)) for k, v in _flatten(flax_params).items()}


@pytest.mark.parametrize("layer_num,use_res", [(1, True), (2, True), (1, False)])
def test_interacting_layer_matches_flax(layer_num, use_res):
    rng = np.random.default_rng(layer_num)
    x = rng.standard_normal((64, 9, 8)).astype(np.float32)
    kw = dict(layer_num=layer_num, unit_num=8, head_num=2, use_dropout=True,
              dropout_rate=0.2, use_res=use_res)
    jlayer = jnn.InteractingLayer(**kw)
    params = jlayer.init(jax.random.PRNGKey(layer_num), x, training=False)["params"]
    want = jlayer.apply({"params": params}, x, training=False)

    layer = InteractingLayer(8, **kw)
    tparams = _torch_params(params)
    assert set(tparams) == {k for k, _ in layer.named_parameters()}
    with torch.no_grad():
        got = functional_call(layer, tparams, (torch.from_numpy(x),),
                              {"training": False})
    assert got.shape == (64, 9, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("units,act", [((32, 16), "relu"), ((1,), "sigmoid")])
def test_multi_layer_dense_matches_flax(units, act):
    rng = np.random.default_rng(len(units))
    x = rng.standard_normal((64, 192)).astype(np.float32)
    jmlp = jnn.MultiLayerDense(units=units, activation=act)
    params = jmlp.init(jax.random.PRNGKey(0), x)["params"]
    want = jmlp.apply({"params": params}, x)

    mlp = MultiLayerDense(192, units, act)
    tparams = _torch_params(params)
    assert {k: tuple(v.shape) for k, v in tparams.items()} == \
        {k: tuple(p.shape) for k, p in mlp.named_parameters()}
    with torch.no_grad():
        got = functional_call(mlp, tparams, (torch.from_numpy(x),))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_glorot_uniform_bounds_and_seed():
    g = torch.Generator().manual_seed(0)
    w = glorot_uniform_(torch.empty(192, 32), g)
    a = (6.0 / (192 + 32)) ** 0.5
    assert float(w.abs().max()) <= a
    assert float(w.abs().max()) > 0.9 * a
    again = glorot_uniform_(torch.empty(192, 32), torch.Generator().manual_seed(0))
    assert torch.equal(w, again)


def test_interacting_layer_rejects_bad_input():
    layer = InteractingLayer(8, unit_num=8, head_num=2)
    with pytest.raises(ValueError):
        layer(torch.zeros(4, 8))
    with pytest.raises(ValueError):
        InteractingLayer(8, unit_num=8, head_num=3)
