"""The port's rough_rank layers and stacked experts against the JAX
package's: ``DNN`` (with ``output_activation`` and ``l2_reg``),
``CrossNet``, ``MMOE``, ``PLE`` (2 tasks, 4 + 4 experts), ``Similarity``,
``kd_loss``, ``GateTower``, ``MMOEStacked``, ``PLEStacked`` and
``stacked_gated_experts``, each with the flax parameters carried across by
name (the flattened tree is the port layer's state dict), forward and
gradients of a random cotangent; the L2 penalties that ``l2_reg`` sows,
stacked ones summed over their experts; every loss of ``LOSSES``.

Tolerances: outputs rtol 1e-5, atol 2e-6 (float32 products summed in
another order); gradients rtol 1e-5, atol 1e-5; losses and penalties rtol
1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu import nn as jnn
from recommendsystem_tpu.train import losses as JL
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch import nn as pnn
from recommendsystem_tpu_torch.train import losses as PL

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
B, IN = 16, 24


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _check(jlayer, player, inputs, seed=0, jkw=None, pkw=None):
    """Init ``jlayer`` on ``inputs`` (numpy), carry its params into
    ``player``, and hold the outputs and the gradients of a random
    cotangent (inputs and params) to JAX's.  Returns the flax params."""
    jkw, pkw = jkw or {}, pkw or {}
    jin = [jnp.asarray(x) for x in inputs]
    variables = jlayer.init(jax.random.PRNGKey(seed), *jin, **jkw)
    params = variables["params"]
    flat = bridge._flatten(jax.tree.map(np.asarray, params))
    names = [n for n, _ in player.named_parameters()]
    assert set(flat) == set(names)
    with torch.no_grad():
        for n, p in player.named_parameters():
            assert tuple(p.shape) == flat[n].shape, n
            p.copy_(torch.tensor(flat[n]))

    def f(p, *xs):
        return tuple(_as_list(jlayer.apply({"params": p}, *xs, **jkw)))

    want, vjp = jax.vjp(f, params, *jin)
    rng = np.random.default_rng(seed + 100)
    cot = tuple(rng.standard_normal(w.shape).astype(np.float32) for w in want)
    jgrads = vjp(tuple(jnp.asarray(c) for c in cot))
    pin = [torch.tensor(x, requires_grad=True) for x in inputs]
    got = _as_list(player(*pin, **pkw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    plist = [p for _, p in player.named_parameters()]
    grads = torch.autograd.grad(got, pin + plist, [torch.from_numpy(c) for c in cot])
    for g, w in zip(grads[:len(pin)], jgrads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    want_p = bridge._flatten(jax.tree.map(np.asarray, jgrads[0]))
    for n, g in zip(names, grads[len(pin):]):
        np.testing.assert_allclose(g.numpy(), want_p[n], **GRAD_TOL, err_msg=n)
    return params


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape or (B, IN)).astype(np.float32)


@pytest.mark.parametrize("units,act,out_act", [((32, 16), "relu", None),
                                                ((16,), "relu", "linear"),
                                                ((8, 5), "tanh", "softmax")])
def test_dnn_matches_jax(units, act, out_act):
    _check(jnn.DNN(units, activation=act, output_activation=out_act),
           pnn.DNN(IN, units, activation=act, output_activation=out_act), [_x(1)])


def test_dnn_refuses_batch_norm():
    with pytest.raises(NotImplementedError, match="use_bn"):
        pnn.DNN(IN, (8,), use_bn=True)


def test_dnn_dropout_draws_from_the_generator():
    layer = pnn.DNN(IN, (64,), dropout_rate=0.5)
    x = torch.from_numpy(_x(2))
    a, b, c = (layer(x, True, torch.Generator().manual_seed(s)) for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    torch.testing.assert_close(layer(x), layer(x, False, torch.Generator()))
    # kept units are scaled by 1 / (1 - rate)
    full = layer(x)
    kept = a != 0
    torch.testing.assert_close(a[kept], 2 * full[kept])


def test_crossnet_matches_jax():
    _check(jnn.CrossNet(layer_num=2), pnn.CrossNet(IN, layer_num=2), [_x(3)])


def test_mmoe_matches_jax():
    _check(jnn.MMOE(num_tasks=2, num_experts=3, expert_dnn_units=(16,), gate_dnn_units=(8,)),
           pnn.MMOE(IN, num_tasks=2, num_experts=3, expert_dnn_units=(16,),
                    gate_dnn_units=(8,)), [_x(4)])


@pytest.mark.parametrize("stacked,units", [(False, (32,)), (False, (16, 8)), (True, (32,))])
def test_ple_matches_jax(stacked, units):
    """Experts of one layer and of two; gates of none."""
    kw = dict(num_tasks=2, num_shared_experts=4, num_specific_experts=4,
              expert_dnn_units=units, gate_dnn_units=())
    jcls, pcls = (jnn.PLEStacked, pnn.PLEStacked) if stacked else (jnn.PLE, pnn.PLE)
    params = _check(jcls(**kw), pcls(IN, **kw), [_x(5)])
    if stacked:
        assert params["experts"]["kernel0"].shape == (4, IN, 32)
        assert params["specific_experts"]["kernel0"].shape == (8, IN, 32)


@pytest.mark.parametrize("units,rate", [((16,), 0.0), ((16, 8), 0.0), ((16, 8), 0.5)])
def test_ple_one_product_equals_the_per_module_path(units, rate):
    """The one product over every module's first layer against each module
    applied on its own (3 tasks, 2 + 3 experts), in training: with dropout
    the draws come from the generator in the same module order."""
    torch.manual_seed(30)
    layer = pnn.PLE(IN, num_tasks=3, num_shared_experts=2, num_specific_experts=3,
                    expert_dnn_units=units, gate_dnn_units=(4,),
                    expert_dnn_params={"dropout_rate": rate},
                    gate_dnn_params={"dropout_rate": rate})
    x = torch.from_numpy(_x(30))
    fused = layer(x, True, torch.Generator().manual_seed(31))
    gen = torch.Generator().manual_seed(31)
    shared = [getattr(layer, f"shared_expert{i}")(x, True, gen) for i in range(2)]
    for i, out in enumerate(fused):
        specific = [getattr(layer, f"task{i}_expert{j}")(x, True, gen) for j in range(3)]
        gate = getattr(layer, f"task{i}_gate")(x, True, gen)
        want = pnn.moe.pool(torch.stack(shared + specific, dim=-2), gate)
        torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-7)


def test_mmoe_stacked_matches_jax():
    kw = dict(num_tasks=3, num_experts=4, expert_dnn_units=(16, 8), gate_dnn_units=(8,))
    params = _check(jnn.MMOEStacked(**kw), pnn.MMOEStacked(IN, **kw), [_x(6)])
    assert params["experts"]["kernel1"].shape == (4, 16, 8)


def test_stacked_gated_experts_match_jax():
    """(B, E, D) in JAX; the port's stack gives (E, B, D)."""
    import flax.linen as fnn

    class Wrap(fnn.Module):
        @fnn.compact
        def __call__(self, x, gate):
            return jnn.stacked_gated_experts(3, (16, 8), x, gate)

    layer = pnn.stacked_gated_experts(3, (16, 8), IN, 10)

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.experts = layer

        def forward(self, x, gate):
            return self.experts(x, gate).transpose(0, 1)

    params = _check(Wrap(), Port(), [_x(7), _x(8, B, 10)])
    assert params["experts"]["gate_1_2"]["kernel"].shape == (3, 8, 8)


def test_similarity_kd_loss_and_gate_tower_match_jax():
    u, i = _x(9, B, 16), _x(10, B, 16)
    for sig in (False, True):
        want = jnn.Similarity(use_sigmoid=sig).apply({}, (jnp.asarray(u), jnp.asarray(i)))
        got = pnn.Similarity(use_sigmoid=sig)((torch.from_numpy(u), torch.from_numpy(i)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    s, t = _x(11, B, 1), _x(12, B, 1)
    want = jnn.kd_loss(jnp.asarray(s), jnp.asarray(t))
    got = pnn.kd_loss(torch.from_numpy(s), torch.from_numpy(t))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_RTOL)
    _check(jnn.GateTower(12, hidden_units=20), pnn.GateTower(IN, 12, hidden_units=20), [_x(13)])
    _check(jnn.GateTower(12, scale=3.0), pnn.GateTower(IN, 12, scale=3.0), [_x(14)])


def _sown(jlayer, inputs, seed=0):
    variables = jlayer.init(jax.random.PRNGKey(seed), *[jnp.asarray(x) for x in inputs])
    _, state = jlayer.apply({"params": variables["params"]},
                            *[jnp.asarray(x) for x in inputs], mutable=["losses"])
    total = sum(float(jnp.sum(v)) for v in jax.tree.leaves(state["losses"]))
    return variables["params"], total


@pytest.mark.parametrize("case", ["dnn", "crossnet", "mmoe_stacked", "ple_stacked"])
def test_l2_penalties_match_the_sown_losses(case):
    """``regularized_kernels`` finds a DNN's, CrossNet's and a stacked
    DNN's kernels; ``kernel_penalty`` over them equals the sum of every
    leaf JAX sows (a stacked penalty summed over its experts)."""
    exp = {"l2_reg": 0.03}
    jlayer, player = {
        "dnn": (jnn.DNN((16, 8), l2_reg=0.02), pnn.DNN(IN, (16, 8), l2_reg=0.02)),
        "crossnet": (jnn.CrossNet(layer_num=3, l2_reg=0.05),
                     pnn.CrossNet(IN, layer_num=3, l2_reg=0.05)),
        "mmoe_stacked": (jnn.MMOEStacked(num_tasks=2, num_experts=3, expert_dnn_params=exp),
                         pnn.MMOEStacked(IN, num_tasks=2, num_experts=3,
                                         expert_dnn_params=exp)),
        "ple_stacked": (jnn.PLEStacked(num_tasks=2, expert_dnn_params=exp,
                                       gate_dnn_params={"l2_reg": 0.01}),
                        pnn.PLEStacked(IN, num_tasks=2, expert_dnn_params=exp,
                                       gate_dnn_params={"l2_reg": 0.01}))}[case]
    params, want = _sown(jlayer, [_x(15)])
    groups = pnn.regularized_kernels(player)
    flat = {n: torch.tensor(v)
            for n, v in bridge._flatten(jax.tree.map(np.asarray, params)).items()}
    names = [n for ns in groups.values() for n in ns]
    assert names and all(n in flat for n in names)
    assert all(l1 == 0.0 for l1, _ in groups)
    got = float(pnn.kernel_penalty(groups, flat))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_every_loss_matches_jax():
    """Against the jitted JAX losses, as the train step takes them (XLA
    folds ``1 - p + 1e-6`` into ``(1 + 1e-6) - p``, which the port writes;
    a probability of exactly 1 is among the inputs)."""
    import functools

    assert set(PL.LOSSES) == set(JL.LOSSES)
    rng = np.random.default_rng(16)
    prob = rng.uniform(0, 1, (B, 3)).astype(np.float32)
    prob[0, 0], prob[1, 0], prob[2, 1] = 0.0, 1.0, 1e-9        # past the clips
    binary = (rng.uniform(size=(B, 3)) < 0.4).astype(np.float32)
    dist = rng.dirichlet(np.ones(6), B).astype(np.float32)
    value = rng.normal(1.0, 2.0, (B, 1)).astype(np.float32)
    ms = rng.integers(0, 400_000, (B, 1)).astype(np.float32)
    cases = {
        "cross_entropy_sum_mean": (binary, prob),
        "cross_entropy_per_sample": (binary, prob),
        "cross_entropy_elementwise": (binary, prob),
        "kl": (np.concatenate([dist, value], 1), np.concatenate([dist[::-1], value], 1)),
        "mse_clip": (np.abs(value) * 2, value),
        "huber": (value, value[::-1] * 0.7),
        "log_mse": (ms, value),
        "y_pred": (binary, value),
        "bce": (binary, prob),
    }
    kwargs = {"kl": {"multiclass_num": 6}}
    for name, (y, p) in cases.items():
        jfn = jax.jit(functools.partial(JL.LOSSES[name], **kwargs.get(name, {})))
        want = np.asarray(jfn(jnp.asarray(y), jnp.asarray(p)))
        got = PL.LOSSES[name](torch.from_numpy(y), torch.from_numpy(p),
                              **kwargs.get(name, {})).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-7, err_msg=name)
