"""K6, the fused InteractingLayer iteration, against the JAX package: the
plain version against ``_reference`` and the Pallas kernel in interpret
mode, the autograd Function's gradients against ``jax.grad`` through the
custom VJP, and the ``InteractingLayer`` (which runs K6 where it applies)
against the flax layer under ``set_backend("pallas")`` and against its own
transposed K5 path, which it keeps for the calls K6 does not take.

Tolerances: forward rtol and atol 2e-5 (the JAX package's own for K6: a
softmax over F keys and 8-term dots summed in another order); gradients
rtol 1e-4, atol 1e-5 (as ``tests/test_kernels.py`` holds its K6); layers
rtol 1e-5, atol 2e-6 (the InteractingLayer parity of
``tests/test_torch_interacting.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from recommendsystem_tpu import nn as jnn
from recommendsystem_tpu.kernels import set_backend
from recommendsystem_tpu.kernels.interacting_pallas import _reference
from recommendsystem_tpu.kernels.interacting_pallas import \
    interacting_attention as jax_interacting_attention
from recommendsystem_tpu_torch.bridge import _flatten
from recommendsystem_tpu_torch.kernels import launch_counts
from recommendsystem_tpu_torch.kernels import interacting as k6
from recommendsystem_tpu_torch.nn import InteractingLayer
from recommendsystem_tpu_torch.nn import interacting as nn_interacting

torch.set_num_threads(1)
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LAYER_TOL = dict(rtol=1e-5, atol=2e-6)


def _params(rng, d=8, u=8):
    """Glorot-scale weights, nonzero biases, gamma around 1."""
    p = {}
    for name in k6.PARAM_NAMES:
        if name.startswith("w"):
            p[name] = rng.uniform(-0.6, 0.6, (d, u))
        elif name == "gamma":
            p[name] = 1.0 + 0.2 * rng.standard_normal(u)
        else:
            p[name] = 0.1 * rng.standard_normal(u)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _torch(p, requires_grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(requires_grad)
            for k, v in p.items()}


@pytest.mark.parametrize("shape,heads", [((16, 13, 8), 2), ((8, 5, 8), 2),
                                         ((4, 1, 8), 2), ((1, 7, 8), 2),
                                         ((6, 9, 8), 4)])
def test_plain_matches_jax_reference_and_kernel(shape, heads):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    x = rng.standard_normal(shape).astype(np.float32)
    p = _params(rng)
    want_ref = np.asarray(_reference(jnp.asarray(x), p, heads, 1e-3))
    want_kernel = np.asarray(jax_interacting_attention(jnp.asarray(x), p, heads, 1e-3))
    got = k6.interacting_attention_plain(torch.from_numpy(x), _torch(p), heads, 1e-3)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), want_ref, **FWD_TOL)
    np.testing.assert_allclose(got.numpy(), want_kernel, **FWD_TOL)
    # the wrapper on a CPU tensor is the plain version, and launches nothing
    before = launch_counts()["interacting_attention"]
    wrapped = k6.interacting_attention(torch.from_numpy(x), _torch(p), heads, 1e-3)
    assert torch.equal(wrapped, got)
    assert launch_counts()["interacting_attention"] == before


def test_function_gradients_match_jax_custom_vjp():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, 5, 8)).astype(np.float32)
    p = _params(rng)

    def loss(x_, p_):
        return jnp.sum(jax_interacting_attention(x_, p_, 2, 1e-3) ** 2)

    gx_want, gp_want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), p)
    xt = torch.from_numpy(x.copy()).requires_grad_()
    pt = _torch(p, requires_grad=True)
    out = k6.interacting_attention(xt, pt, 2, 1e-3)
    assert type(out.grad_fn).__name__.startswith("InteractingAttentionFunction")
    names = list(k6.PARAM_NAMES)
    grads = torch.autograd.grad((out ** 2).sum(), [xt] + [pt[n] for n in names])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_want), **GRAD_TOL)
    for name, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(gp_want[name]),
                                   err_msg=name, **GRAD_TOL)


def test_wrapper_rejects_bad_arguments():
    rng = np.random.default_rng(0)
    p = _torch(_params(rng))
    x = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match=r"\(B, F, D\)"):
        k6.interacting_attention(torch.zeros(2, 8), p)
    with pytest.raises(ValueError, match="heads"):
        k6.interacting_attention(x, p, head_num=3)
    with pytest.raises(ValueError, match="params"):
        k6.interacting_attention(x, {k: v for k, v in p.items() if k != "br"})
    with pytest.raises(ValueError, match="shape"):
        k6.interacting_attention(torch.zeros(2, 3, 4), p)
    with pytest.raises(TypeError):
        k6.interacting_attention(x.double(), p)
    with pytest.raises(ValueError, match="no kernel for device"):
        k6.interacting_attention(x.to("meta"), {k: v.to("meta") for k, v in p.items()})


class _CountCalls:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.fixture
def k6_calls(monkeypatch):
    counter = _CountCalls(nn_interacting.interacting_attention)
    monkeypatch.setattr(nn_interacting, "interacting_attention", counter)
    return counter


def _layer_kw(layer_num=1, use_dropout=True):
    return dict(layer_num=layer_num, unit_num=8, head_num=2, use_dropout=use_dropout,
                dropout_rate=0.2, use_res=True)


def _layer_params(rng):
    """The layer's parameters under their flax names."""
    names = {"gamma": "ln_scale", "beta": "ln_bias"}
    return {names.get(k, k): v for k, v in _torch(_params(rng)).items()}


def _transposed(kw, params, x, **kwargs):
    """``forward_transposed`` of a layer built with ``kw``, on ``params``."""
    layer = InteractingLayer(x.shape[-1], **kw)
    layer.forward = layer.forward_transposed
    return functional_call(layer, params, (x,), kwargs)


@pytest.mark.parametrize("layer_num", [1, 2])
def test_layer_matches_flax_under_pallas(layer_num, k6_calls):
    rng = np.random.default_rng(layer_num + 20)
    x = rng.standard_normal((24, 11, 8)).astype(np.float32)
    kw = _layer_kw(layer_num)
    jlayer = jnn.InteractingLayer(**kw)
    params = jlayer.init(jax.random.PRNGKey(layer_num), x, training=False)["params"]
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in _flatten(params).items()}
    set_backend("pallas")
    try:
        want = jlayer.apply({"params": params}, x, training=False)
    finally:
        set_backend(None)
    layer = InteractingLayer(8, **kw)
    with torch.no_grad():
        got = functional_call(layer, tparams, (torch.from_numpy(x),), {"training": False})
        transposed = _transposed(kw, tparams, torch.from_numpy(x), training=False)
    assert k6_calls.calls == layer_num
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(got.numpy(), transposed.numpy(), **LAYER_TOL)


def test_training_with_dropout_takes_the_k5_path(k6_calls):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((16, 9, 8)).astype(np.float32))
    kw, tparams = _layer_kw(), _layer_params(rng)
    layer = InteractingLayer(8, **kw)
    got = functional_call(layer, tparams, (x,), {"training": True, "seed": 5})
    want = _transposed(kw, tparams, x, training=True, seed=5)
    assert k6_calls.calls == 0
    assert torch.equal(got, want)
    eval_out = _transposed(kw, tparams, x, training=False)
    assert not torch.allclose(got, eval_out)         # dropout did act


def test_training_without_dropout_runs_the_function(k6_calls):
    """ctr with ``attention_dropout_rate=0``: a training call goes through
    K6's autograd Function, with the transposed K5 path's gradients."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((12, 7, 8)).astype(np.float32)
    kw, tparams = _layer_kw(use_dropout=False), _layer_params(rng)
    layer = InteractingLayer(8, **kw)
    results = []
    for fused in (True, False):
        params = {k: v.clone().requires_grad_() for k, v in tparams.items()}
        xt = torch.from_numpy(x.copy()).requires_grad_()
        if fused:
            out = functional_call(layer, params, (xt,), {"training": True, "seed": 1})
            assert type(out.grad_fn).__name__.startswith("InteractingAttentionFunction")
        else:
            out = _transposed(kw, params, xt, training=True, seed=1)
        grads = torch.autograd.grad((out ** 2).sum(), [xt] + list(params.values()))
        results.append((out.detach(), grads))
    assert k6_calls.calls == 1
    np.testing.assert_allclose(results[0][0].numpy(), results[1][0].numpy(), **LAYER_TOL)
    for a, b in zip(results[0][1], results[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("in_dim,units,fields,use_res", [
    (16, 16, 9, True),      # widths the kernel is not built for
    (8, 8, 257, True),      # more fields than a block holds
    (8, 8, 9, False)])      # no residual projection
def test_layer_keeps_k5_where_the_kernel_does_not_apply(k6_calls, in_dim, units, fields,
                                                         use_res):
    """Against the flax layer under the default backend, with K6 not called."""
    rng = np.random.default_rng(in_dim + fields)
    x = rng.standard_normal((3, fields, in_dim)).astype(np.float32)
    kw = dict(layer_num=1, unit_num=units, head_num=2, use_dropout=True,
              dropout_rate=0.2, use_res=use_res)
    jlayer = jnn.InteractingLayer(**kw)
    params = jlayer.init(jax.random.PRNGKey(fields), x, training=False)["params"]
    want = jlayer.apply({"params": params}, x, training=False)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in _flatten(params).items()}
    with torch.no_grad():
        got = functional_call(InteractingLayer(in_dim, **kw), tparams,
                              (torch.from_numpy(x),), {"training": False})
    assert k6_calls.calls == 0
    assert got.shape == (3, fields, units)
    # a softmax over 257 keys sums in another order as K6's tolerance allows
    tol = FWD_TOL if fields > 256 else LAYER_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
