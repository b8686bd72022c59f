"""The staytime layers of the port against the JAX package: K7's plain
version and its autograd Function, DINPool, SENet, the FM blocks, the
DeepCross layer and the staytime losses.  Inputs are made with numpy from
seeds and handed to both.

Tolerances: K7's plain version against the JAX kernel (interpret mode) and
its block math rtol 2e-5, atol 2e-5, as the JAX package holds its own
kernel (a softmax over T and 4H-term dots summed in another order); its
gradients rtol 1e-4, atol 1e-5; the layers rtol 1e-5, atol 2e-6 (float32
products in another order); the losses rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.kernels.din_pallas import _din_block
from recommendsystem_tpu.kernels.din_pallas import din_pool as jax_din_pool
from recommendsystem_tpu.nn import dcn as jax_dcn
from recommendsystem_tpu.nn import din as jax_din
from recommendsystem_tpu.nn import fm as jax_fm
from recommendsystem_tpu.nn import senet as jax_senet
from recommendsystem_tpu.train import losses as jax_losses
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.kernels.din import MASK_PAD, din_pool, din_pool_plain
from recommendsystem_tpu_torch.nn import (DeepCrossLayer, DINPool, FFMBlock, SENet,
                                          fm_cross_term, sequence_mask)
from recommendsystem_tpu_torch.nn import din as port_din
from recommendsystem_tpu_torch.train import losses as port_losses

torch.set_num_threads(1)
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LAYER_TOL = dict(rtol=1e-5, atol=2e-6)


def _din_inputs(b, t, h, seed, strided=False):
    """numpy (q, facts, mask, w1, b1, w2, b2): row 0 of the mask all 0 with
    nonzero facts there, the last row of full length; ``strided`` gives q
    and facts as the first H lanes of 2H-lane rows, as the model does."""
    rng = np.random.default_rng(seed)
    wide = 2 * h if strided else h
    q = rng.normal(size=(b, wide)).astype(np.float32)
    f = rng.normal(size=(b, t, wide)).astype(np.float32)
    lens = rng.integers(1, t + 1, size=(b,))
    lens[0], lens[-1] = 0, t
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    lim1, lim2 = np.sqrt(6.0 / (4 * h + 16)), np.sqrt(6.0 / 17)
    w1 = rng.uniform(-lim1, lim1, size=(4 * h, 16)).astype(np.float32)
    b1 = rng.normal(scale=0.1, size=(16,)).astype(np.float32)
    w2 = rng.uniform(-lim2, lim2, size=(16, 1)).astype(np.float32)
    b2 = rng.normal(scale=0.1, size=(1,)).astype(np.float32)
    return q, f, mask, w1, b1, w2, b2


def _torch(args, h, requires_grad=False):
    q, f, mask, w1, b1, w2, b2 = (torch.from_numpy(a) for a in args)
    q, f = q[:, :h], f[:, :, :h]                     # views when strided
    out = [q, f, mask, w1, b1, w2, b2]
    if requires_grad:
        for i in (0, 1, 3, 4, 5, 6):
            out[i] = out[i].detach().requires_grad_()
    return out


def _jax(args, h):
    q, f, mask, w1, b1, w2, b2 = (jnp.asarray(a) for a in args)
    return [q[:, :h], f[:, :, :h], mask, w1, b1, w2, b2]


DIN_CASES = [(12, 7, 16, False), (5, 50, 16, True), (9, 3, 8, False),
             (4, 33, 32, True), (2, 50, 16, True)]


@pytest.mark.parametrize("b,t,h,strided", DIN_CASES)
def test_din_pool_plain_matches_jax_kernel_and_block(b, t, h, strided):
    args = _din_inputs(b, t, h, seed=b * t + h, strided=strided)
    tin = _torch(args, h)
    if strided:
        assert not tin[0].is_contiguous() and not tin[1].is_contiguous()
    got = din_pool_plain(*tin).numpy()
    jin = _jax(args, h)
    np.testing.assert_allclose(got, np.asarray(jax_din_pool(*jin)), **KERNEL_TOL)
    np.testing.assert_allclose(got, np.asarray(_din_block(*jin)), **KERNEL_TOL)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    reset_launch_counts()
    np.testing.assert_array_equal(din_pool(*tin).numpy(), got)
    assert launch_counts()["din_pool"] == 0


def test_all_masked_row_is_the_mean_of_its_facts():
    """MASK_PAD replaces the scores: a row whose mask is all 0 gets a uniform
    softmax over T and returns the mean of its (nonzero) facts, not NaN."""
    args = _din_inputs(6, 9, 16, seed=3)
    q, f, mask, *w = _torch(args, 16)
    assert float(mask[0].sum()) == 0.0 and float(f[0].abs().min()) > 0.0
    got = din_pool_plain(q, f, mask, *w)
    torch.testing.assert_close(got[0], f[0].mean(dim=0), rtol=1e-6, atol=1e-6)
    assert bool(torch.isfinite(got).all())
    assert MASK_PAD == -(2.0 ** 32) + 1.0
    assert float(torch.tensor(MASK_PAD, dtype=torch.float32)) == -(2.0 ** 32)


@pytest.mark.parametrize("b,t,h,strided", [(6, 5, 16, False), (7, 50, 16, True),
                                           (5, 4, 8, True)])
def test_din_pool_gradients_match_jax(b, t, h, strided):
    args = _din_inputs(b, t, h, seed=100 + b, strided=strided)
    g = np.random.default_rng(7).normal(size=(b, h)).astype(np.float32)
    tin = _torch(args, h, requires_grad=True)
    out = din_pool(*tin)
    assert out.grad_fn is not None and "DinPoolFunction" in type(out.grad_fn).__name__
    wrt = [tin[i] for i in (0, 1, 3, 4, 5, 6)]
    got = torch.autograd.grad(out, wrt, torch.from_numpy(g))

    jin = _jax(args, h)

    def loss(q, f, w1, b1, w2, b2):
        return jnp.sum(jax_din_pool(q, f, jin[2], w1, b1, w2, b2) * g)

    want = jax.grad(loss, argnums=tuple(range(6)))(*[jin[i] for i in (0, 1, 3, 4, 5, 6)])
    for name, a, w in zip(("q", "facts", "w1", "b1", "w2", "b2"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)


def test_din_pool_mask_gets_no_gradient():
    args = _din_inputs(4, 6, 16, seed=9)
    q, f, mask, w1, b1, w2, b2 = _torch(args, 16, requires_grad=True)
    mask.requires_grad_()
    out = din_pool(q, f, mask, w1, b1, w2, b2)
    dq, dmask = torch.autograd.grad(out.sum(), (q, mask), allow_unused=True)
    assert dq is not None and dmask is None


def test_din_pool_rejects_bad_shapes():
    q, f, mask, w1, b1, w2, b2 = _torch(_din_inputs(3, 4, 16, seed=1), 16)
    with pytest.raises(ValueError, match="do not fit"):
        din_pool(q[:2], f, mask, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="w1"):
        din_pool(q, f, mask, w1[:32], b1, w2, b2)
    with pytest.raises(TypeError):
        din_pool(q, f, mask.bool(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="last dim"):
        din_pool(q, f.transpose(1, 2).contiguous().transpose(1, 2), mask, w1, b1, w2, b2)


def _load_flax(module, params):
    """Copy a flax parameter tree into a port module by its flattened
    names."""
    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", torch.from_numpy(np.array(v))
    state = dict(flat(params))
    assert set(state) == {k for k, _ in module.named_parameters()}
    module.load_state_dict(state, strict=False)
    return module


@pytest.mark.parametrize("hidden,t,with_mask", [(16, 50, True), (8, 5, True), (16, 6, False)])
def test_dinpool_layer_matches_flax(hidden, t, with_mask):
    rng = np.random.default_rng(hidden + t)
    b = 7
    q = rng.normal(size=(b, 32)).astype(np.float32)
    seq = rng.normal(size=(b, t, 32)).astype(np.float32)
    lens = rng.integers(0, t + 1, size=(b,))
    lens[0] = 0
    mask = np.arange(t)[None, :] < lens[:, None]
    jmod = jax_din.DINPool(hidden=hidden)
    jargs = (jnp.asarray(q)[:, :16], jnp.asarray(seq)[:, :, :16],
             jnp.asarray(mask) if with_mask else None)
    params = jmod.init(jax.random.PRNGKey(hidden), *jargs)["params"]
    want = jmod.apply({"params": params}, *jargs)
    pmod = _load_flax(DINPool(16, hidden=hidden), params)
    got = pmod(torch.from_numpy(q)[:, :16], torch.from_numpy(seq)[:, :, :16],
               torch.from_numpy(mask) if with_mask else None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LAYER_TOL)


def test_sequence_mask_matches_jax():
    lens = np.array([0, 3, 5, 1], np.int64)
    np.testing.assert_array_equal(
        sequence_mask(torch.from_numpy(lens), 5).numpy(),
        np.asarray(jax_din.sequence_mask(jnp.asarray(lens), 5)))
    assert port_din.MASK_PAD == jax_din.MASK_PAD


@pytest.mark.parametrize("squeeze", ["concat", "mean"])
def test_senet_matches_flax(squeeze):
    rng = np.random.default_rng(len(squeeze))
    fields = [rng.normal(size=(6, 16)).astype(np.float32) for _ in range(9)]
    jmod = jax_senet.SENet(squeeze=squeeze)
    jin = [jnp.asarray(x) for x in fields]
    params = jmod.init(jax.random.PRNGKey(1), jin)["params"]
    want = jmod.apply({"params": params}, jin)
    pmod = _load_flax(SENet(9, 16, squeeze=squeeze), params)
    got = pmod([torch.from_numpy(x) for x in fields])
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w), **LAYER_TOL)


def test_senet_squeeze_is_detached():
    fields = [torch.randn(4, 16, requires_grad=True) for _ in range(8)]
    pmod = SENet(8, 16, squeeze="concat")
    out = pmod(fields)
    (g,) = torch.autograd.grad(out[0].sum(), fields[1], allow_unused=True)
    assert g is None                 # field 1 reaches field 0 only through the gates


def test_fm_cross_term_matches_jax():
    rng = np.random.default_rng(5)
    fields = [rng.normal(size=(6, 16)).astype(np.float32) for _ in range(11)]
    cross, logit = fm_cross_term([torch.from_numpy(x) for x in fields])
    jcross, jlogit = jax_fm.fm_cross_term([jnp.asarray(x) for x in fields])
    np.testing.assert_allclose(cross.numpy(), np.asarray(jcross), **LAYER_TOL)
    np.testing.assert_allclose(logit.numpy(), np.asarray(jlogit), **LAYER_TOL)
    assert logit.shape == (6, 1)


def test_ffm_block_matches_flax():
    rng = np.random.default_rng(6)
    xs, ys = ("1", "2", "3"), ("4", "5")
    slots = {s: rng.normal(size=(5, 16)).astype(np.float32) for s in xs + ys}
    jmod = jax_fm.FFMBlock(ffm_slots=((xs, ys, 8),))
    jin = {s: jnp.asarray(v) for s, v in slots.items()}
    params = jmod.init(jax.random.PRNGKey(2), jin)["params"]
    want = jmod.apply({"params": params}, jin)
    pmod = _load_flax(FFMBlock(((xs, ys, 8),), {s: 16 for s in slots}), params)
    got = pmod({s: torch.from_numpy(v) for s, v in slots.items()})
    assert got.shape == (5, 6 * 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("num_layer", [3, 1])
def test_deep_cross_layer_matches_flax(num_layer):
    rng = np.random.default_rng(num_layer)
    x = rng.normal(size=(6, 40)).astype(np.float32)
    jmod = jax_dcn.DeepCrossLayer(num_layer=num_layer)
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    # nonzero biases, so that each layer's bias term is checked
    params = jax.tree.map(lambda p: p + 0.05 if p.ndim == 1 else p, params)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    pmod = _load_flax(DeepCrossLayer(40, num_layer=num_layer), params)
    got = pmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LAYER_TOL)


def test_kl_loss_matches_jitted_jax():
    rng = np.random.default_rng(8)
    y_true = np.concatenate([rng.dirichlet(np.ones(400), size=12),
                             rng.uniform(0, 160, size=(12, 1))], axis=1).astype(np.float32)
    y_true[0, :400] = 0.0                               # clipped to 1e-7
    logits = rng.normal(size=(12, 400)).astype(np.float32)
    y_pred = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    y_pred = np.concatenate([y_pred, rng.uniform(0, 160, size=(12, 1))], 1).astype(np.float32)
    y_pred[1, :3] = 0.0
    got = port_losses.kl_loss(torch.from_numpy(y_true), torch.from_numpy(y_pred))
    want = jax.jit(jax_losses.kl_loss)(jnp.asarray(y_true), jnp.asarray(y_pred))
    assert got.shape == (12,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_cross_entropy_elementwise_matches_jitted_jax():
    rng = np.random.default_rng(9)
    y = (rng.uniform(size=(16, 1)) < 0.5).astype(np.float32)
    p = rng.uniform(0.0, 1.0, size=(16, 1)).astype(np.float32)
    p[0], p[1], p[2] = 1.0, 0.0, 1.0 - 2 ** -24         # saturated sigmoids
    y[0], y[2] = 0.0, 0.0
    got = port_losses.cross_entropy_elementwise(torch.from_numpy(y), torch.from_numpy(p))
    want = jax.jit(jax_losses.cross_entropy_elementwise)(jnp.asarray(y), jnp.asarray(p))
    assert got.shape == (16, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
