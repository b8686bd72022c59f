"""The port's L1L2 kernel penalty against the JAX ``Dense``'s sowed
``"losses"`` and against the JAX train step's ``regularization``.

The JAX ``Dense`` sows ``l1 * sum|K| + l2 * sum K^2`` into its ``"losses"``
collection once a call, and the JAX step adds the sum of those leaves to
the loss.  The port computes the same sum from the step's parameter dict
(``nn.kernel_penalty`` over ``nn.regularized_kernels``).  A kernel with entries planted at exactly 0 shows
the |x| trap: ``jax.grad(jnp.abs)`` is 1 at 0, ``torch.abs``'s gradient 0.
Tolerances: the penalty rtol 1e-5 (float32 sums in another order); its
gradient rtol 1e-6 (one product, rounded once on either side).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.nn import Dense as JaxDense
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train.step import make_train_step as jax_make_train_step
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.nn import Dense, kernel_penalty, regularized_kernels
from recommendsystem_tpu_torch.train import make_train_step

torch.set_num_threads(1)
REG_RTOL = 1e-5


class _JaxTower(fnn.Module):
    """Two regularized Dense layers, one inside a submodule, and one
    without a penalty."""
    reg: tuple

    @fnn.compact
    def __call__(self, x):
        x = JaxDense(16, activation="relu", name="a", kernel_regularizer=self.reg)(x)
        x = _JaxInner(self.reg, name="inner")(x)
        return JaxDense(1, name="out")(x)


class _JaxInner(fnn.Module):
    reg: tuple

    @fnn.compact
    def __call__(self, x):
        return JaxDense(8, name="b", kernel_regularizer=self.reg)(x)


class _Inner(torch.nn.Module):
    def __init__(self, reg):
        super().__init__()
        self.b = Dense(16, 8, kernel_regularizer=reg)


class _Tower(torch.nn.Module):
    def __init__(self, reg):
        super().__init__()
        self.a = Dense(12, 16, "relu", kernel_regularizer=reg)
        self.inner = _Inner(reg)
        self.out = Dense(8, 1)


@pytest.mark.parametrize("reg", [(1e-5, 1e-5), (0.0, 0.01)])
def test_penalty_and_gradient_match_the_sowed_losses(reg):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 12)).astype(np.float32)
    jmod = _JaxTower(reg)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    k = params["a"]["kernel"].copy()
    k[::3, ::2] = 0.0                                # entries planted at exactly 0
    params["a"]["kernel"] = k
    zeros = k == 0.0
    assert zeros.sum() > 10

    def sowed(p):
        _, mutated = jmod.apply({"params": p}, jnp.asarray(x), mutable=["losses"])
        return sum(jnp.sum(leaf) for leaf in jax.tree.leaves(mutated["losses"]))

    want, want_g = jax.value_and_grad(sowed)(jax.tree.map(jnp.asarray, params))
    flat = {n: torch.tensor(v, requires_grad=True)
            for n, v in bridge._flatten(params).items()}
    tower = _Tower(reg)
    assert set(flat) == {n for n, _ in tower.named_parameters()}
    got = kernel_penalty(regularized_kernels(tower), flat)
    assert got.ndim == 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=REG_RTOL)
    grads = dict(zip(flat, torch.autograd.grad(got, list(flat.values()), allow_unused=True)))
    want_flat = bridge._flatten(jax.tree.map(np.asarray, want_g))
    for name, g in grads.items():
        if name.endswith("kernel") and not name.startswith("out"):
            np.testing.assert_allclose(g.numpy(), want_flat[name], rtol=1e-6, atol=0,
                                       err_msg=name)
        else:                                        # biases and the unregularized Dense
            assert g is None and not want_flat[name].any(), name
    # the subgradient at 0 is +l1, as jax.grad(jnp.abs) takes it
    np.testing.assert_array_equal(grads["a.kernel"].numpy()[zeros], np.float32(reg[0]))
    assert float(jax.grad(jnp.abs)(0.0)) == 1.0
    t = torch.zeros((), requires_grad=True)
    torch.abs(t).backward()
    assert float(t.grad) == 0.0


def test_unregularized_step_reports_zero_like_jax():
    """autoint has no regularized Dense: the step adds no penalty, and its
    ``regularization`` is a 0-d zero on the params' device, equal to the
    JAX step's (0)."""
    jbundle = jax_create_model("autoint", bucket_size=64)
    pbundle = create_model("autoint", bucket_size=64, device="cpu")
    jb, _, jl, jw = jax_synthetic_batch(jbundle, 8, seed=1)
    pb, _, pl, pw = synthetic_batch(pbundle, 8, seed=1)
    jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(0), jb)
    pstate = bridge.from_jax_numpy(
        pbundle, jax.tree.map(np.asarray, jstate.params),
        {k: np.asarray(v) for k, v in jbundle.embedding.weights(jstate.tables).items()})
    assert regularized_kernels(pbundle.module) == {}
    _, jinfo = jax_make_train_step(jbundle, donate=False, sparse_update="packed")(
        jstate, jb, jl, jw, None, jax.random.PRNGKey(0))
    _, pinfo = make_train_step(pbundle)(pstate, pb, pl, pw, seed=0)
    assert pinfo["regularization"].ndim == 0
    assert pinfo["regularization"].device.type == "cpu"
    assert float(pinfo["regularization"]) == float(jinfo["regularization"]) == 0.0
