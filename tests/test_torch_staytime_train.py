"""The port's staytime train step against the JAX package's packed step,
and the last two layers of ``nn/`` against flax.

Both steps start from the same state, carried by ``bridge.from_jax_numpy``
(dense params, optax's Adam state, the tables' w, g2sum and show), and take
3 steps on the same batch: the fused folds, the KL + 2 CE loss with its
weights (2, 2, 1), dense Adam, then the unfold-scatters and the lazy
AdaGrad pass (K9's plain version here; the JAX package's classic-state
branch of ``apply_gradients_packed``).  Configurations, from
``tests/test_torch_staytime_serving.py``: the 91-slot ``SMALL`` (one
storage) and ``cfg16_split`` (16 slots, three tables a storage, so mean and
sequence columns share storages in several ways), each with 5 ids and with
1, and with and without sample weights (each JAX variant compiles for
~30 s on the 91-slot config, so each config takes two of the four).
Tolerances, as the other train-step tests: losses rtol 1e-5; w and dense
params atol 1e-5; g2sum and Adam's moments rtol 1e-4, atol 1e-9; show
exact.  One kind of dense entry cannot be held to atol 1e-5: a gradient
that is 0 in exact arithmetic.  The DIN scorer's ``b2`` shifts every score
of a softmax over T alike, so the loss does not depend on it, and its
float32 gradient is rounding noise of ~1e-10 on either side; Adam divides
that noise by (|noise| + eps = 1e-8), so each package moves the bias by up
to ~1e-5 a step at lr 5e-4, each in its own direction.  An entry past
atol 1e-5 passes only where both packages' first moments of it are within
1e-9 of 0 (``MOMENT_TOL``'s atol: every gradient of it at most ~1e-8, where
the step's others are ~1e-3 or more), and the test counts that every such
entry is a DIN ``b2``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.nn.din import DINAttention as JaxDINAttention
from recommendsystem_tpu.nn.fm import FMLayer3D as JaxFMLayer3D
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train.step import make_train_step as jax_make_train_step
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.nn import DINAttention, FMLayer3D
from recommendsystem_tpu_torch.train import make_train_step
from test_torch_autoint_train import ATOL, LOSS_RTOL, MOMENT_TOL, _flat
from test_torch_staytime_serving import _bundles

torch.set_num_threads(1)
G2SUM_TOL = dict(rtol=1e-4, atol=1e-9)
LAYER_TOL = dict(rtol=1e-5, atol=2e-6)
BATCH = 16


@pytest.fixture(scope="module", params=["small", "cfg16_split"])
def pair(request):
    """(name, JAX bundle, JAX initial state, port bundle): one JAX bundle
    and state a config."""
    jbundle, pbundle = _bundles(request.param)
    jb = jax_synthetic_batch(jbundle, BATCH, seed=0)[0]
    jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(1), jb)
    return request.param, jbundle, jstate, pbundle


def _bridged(jbundle, jstate, pbundle):
    return bridge.from_jax_numpy(
        pbundle, jax.tree.map(np.asarray, jstate.params),
        jax.device_get(jbundle.embedding.classic_state(jstate.tables)),
        opt_state=jax.tree.map(np.asarray, jstate.opt_state))


def _assert_states_match(jbundle, jstate, pstate):
    jc = jax.device_get(jbundle.embedding.classic_state(jstate.tables))
    assert set(jc) == set(pstate.tables)
    for skey, want in jc.items():
        got = pstate.tables[skey]
        assert set(got["opt"]) == set(want["opt"]) == {"g2sum"}
        np.testing.assert_allclose(got["w"].numpy(), want["w"], rtol=0, atol=ATOL,
                                   err_msg=skey)
        np.testing.assert_allclose(got["opt"]["g2sum"].numpy(), want["opt"]["g2sum"],
                                   **G2SUM_TOL, err_msg=skey)
        np.testing.assert_array_equal(got["show"].numpy(), want["show"], err_msg=skey)
    jp = _flat(jax.device_get(jstate.params))
    mu = _flat(jax.device_get(jstate.opt_state[0].mu))
    assert set(jp) == set(pstate.params)
    noise = set()
    for k, v in jp.items():
        got = pstate.params[k].numpy()
        past = np.abs(got - v) > ATOL
        if past.any():
            # a gradient of 0 in exact arithmetic (see the module docstring)
            for m in (mu[k][past], pstate.opt_state["mu"][k].numpy()[past]):
                np.testing.assert_array_less(np.abs(m), MOMENT_TOL["atol"], err_msg=k)
            noise.add(k)
        np.testing.assert_allclose(got[~past], v[~past], rtol=0, atol=ATOL, err_msg=k)
    assert all(k.startswith("din_") and k.endswith(".b2") for k in noise), noise
    assert pstate.opt_state["count"] == int(jstate.opt_state[0].count)


# (config, ids a feature, sample weights): each config with 5 ids and 1,
# weighted and not
CASES = {"small": ((5, True), (1, False)), "cfg16_split": ((5, False), (1, True))}


@pytest.mark.parametrize("case", [0, 1])
def test_three_steps_match_jax_packed_steps(pair, case):
    name, jbundle, jstate, pbundle = pair
    ids_per_feature, weighted = CASES[name][case]
    pstate = _bridged(jbundle, jstate, pbundle)
    jb, jd, jl, jw = jax_synthetic_batch(jbundle, BATCH, seed=3 + case,
                                         ids_per_feature=ids_per_feature)
    pb, pd, pl, pw = synthetic_batch(pbundle, BATCH, seed=3 + case,
                                     ids_per_feature=ids_per_feature)
    # the synthetic staytime weights are 1 but for high-play samples: draw
    # weights of 0.5-2 so that every sample's weight counts
    weight = np.random.default_rng(case).uniform(0.5, 2.0, (BATCH, 1)).astype(np.float32)
    jw, pw = (jnp.asarray(weight), torch.tensor(weight)) if weighted else (None, None)
    jstep = jax_make_train_step(jbundle, donate=False, sparse_update="packed")
    pstep = make_train_step(pbundle)
    reset_launch_counts()
    for i in range(3):
        jstate, jinfo = jstep(jstate, jb, jl, jw, jd, jax.random.PRNGKey(i))
        pstate, pinfo = pstep(pstate, pb, pl, pw, pd, seed=i)
        jinfo = jax.device_get(jinfo)
        assert set(pinfo) == set(jinfo) | {"regularization"}
        for key, want in jinfo.items():
            np.testing.assert_allclose(float(pinfo[key]), float(want), rtol=LOSS_RTOL,
                                       err_msg=f"{name} step {i} {key}")
        assert float(pinfo["regularization"]) == 0.0
    assert pstate.step == 3
    _assert_states_match(jbundle, jstate, pstate)
    assert set(launch_counts().values()) == {0}
    for skey in pbundle.embedding.storage:
        assert not pbundle.embedding.accumulator(skey, "cpu").any()


def test_show_counts_and_weights_drive_the_step(pair):
    """After 2 steps on one batch show is twice the live counts, rows no
    column touched keep their g2sum, and the sample weights reach the loss
    (all-ones weights give the unweighted loss, others another)."""
    name, jbundle, jstate, pbundle = pair
    pb, pd, pl, pw = synthetic_batch(pbundle, BATCH, seed=7)
    counts = pbundle.embedding.row_counts(pb)
    step = make_train_step(pbundle)
    losses = {}
    drawn = torch.tensor(np.random.default_rng(8).uniform(0.5, 2.0, (BATCH, 1)),
                         dtype=torch.float32)
    for label, weight in (("none", None), ("ones", torch.ones_like(pw)), ("drawn", drawn)):
        state = _bridged(jbundle, jstate, pbundle)
        g2 = {k: t["opt"]["g2sum"].clone() for k, t in state.tables.items()}
        shows = {k: t["show"].clone() for k, t in state.tables.items()}
        for i in range(2):
            state, info = step(state, pb, pl, weight, pd, seed=i)
            losses.setdefault(label, []).append(float(info["loss"]))
        for skey, tstate in state.tables.items():
            torch.testing.assert_close(tstate["show"], shows[skey] + 2 * counts[skey],
                                       rtol=0, atol=0)
            dead = counts[skey][:, 0] == 0
            assert torch.equal(tstate["opt"]["g2sum"][dead], g2[skey][dead])
            assert (tstate["opt"]["g2sum"][~dead] > g2[skey][~dead]).all()
    np.testing.assert_allclose(losses["ones"], losses["none"], rtol=1e-6)
    assert abs(losses["drawn"][0] - losses["none"][0]) > 1e-4


@pytest.mark.parametrize("shape", [(4, 6, 8), (1, 1, 3), (5, 40, 16)])
def test_fm_layer_3d_matches_flax(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    layer = JaxFMLayer3D()
    want = layer.apply(layer.init(jax.random.PRNGKey(0), jnp.asarray(x)), jnp.asarray(x))
    got = FMLayer3D()(torch.tensor(x))
    assert tuple(got.shape) == (shape[0], 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    with pytest.raises(ValueError, match="3 dimensions"):
        FMLayer3D()(torch.zeros((2, 3)))


@pytest.mark.parametrize("f,masked,units", [(None, True, (16, 1)), (3, True, (16, 1)),
                                            (2, False, (8, 4, 1))])
def test_din_attention_matches_flax(f, masked, units):
    """Outputs and gradients of the general DIN against the flax layer from
    the same parameters (``din_nn_{i}``), with (B, H) and (B, F, H) queries
    and with and without a mask (masked scores are 0, not -2^32)."""
    b, t, h = 5, 7, 8
    rng = np.random.default_rng(len(units) + (f or 0))
    q = rng.standard_normal((b, h) if f is None else (b, f, h)).astype(np.float32)
    k = rng.standard_normal((b, t, h)).astype(np.float32)
    v = rng.standard_normal((b, t, h)).astype(np.float32)
    mask = (rng.uniform(size=(b, t)) < 0.6) if masked else None
    layer = JaxDINAttention(hidden_units=units)
    args = [jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if mask is None else jnp.asarray(mask)]
    params = layer.init(jax.random.PRNGKey(3), *args)["params"]
    # shift the biases so that ReLU units sit on both sides of 0
    params = jax.tree.map(lambda p: p + 0.1 if p.ndim == 1 else p, params)
    want = layer.apply({"params": params}, *args)

    def loss_fn(p, q_, k_, v_):
        return jnp.sum(jnp.sin(layer.apply({"params": p}, q_, k_, v_, args[3])))

    jgrads = jax.grad(loss_fn, argnums=(0, 1, 2, 3))(params, *args[:3])
    port = DINAttention(h, units)
    assert set(dict(port.named_parameters())) == set(_flat(params))
    with torch.no_grad():
        for key, p in port.named_parameters():
            p.copy_(torch.tensor(np.asarray(_flat(params)[key])))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = port(tq, tk, tv, None if mask is None else torch.tensor(mask))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LAYER_TOL)
    torch.sin(got).sum().backward()
    jflat = _flat(jax.device_get(jgrads[0]))
    for key, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jflat[key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    for tensor, jg in zip((tq, tk, tv), jgrads[1:]):
        np.testing.assert_allclose(tensor.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="one unit"):
        DINAttention(h, (16, 2))
