"""The port's finish model against the JAX package: ``DeepFMLayer`` alone
(forward, gradients, the glorot-normal init's scale), the bridge of the
whole flax tree, the predict step and the scoring service, and 3 packed
train steps from the bridged state (as ``tests/test_torch_ctr_train.py``).

Configuration: 12 slots ``3000..3011`` of dim 32 over 256-id buckets, the
first 4 the bias slots (the general concat 8 x 16 + 16 = 144 wide), deep
units (64, 32).  Tolerances: scores rtol 1e-5, atol 2e-6 (float32 products
summed in another order); the train step's as
``tests/test_torch_autoint_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.nn import DeepFMLayer as JaxDeepFMLayer
from recommendsystem_tpu.serving import ScoringService as JaxScoringService
from recommendsystem_tpu.train.step import make_predict_step as jax_make_predict_step
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.finish import TASK
from recommendsystem_tpu_torch.nn import DeepFMLayer
from recommendsystem_tpu_torch.serving import ScoringService
from recommendsystem_tpu_torch.serving import server as port_server
from recommendsystem_tpu_torch.train import make_predict_step
from test_torch_autoint_train import _assert_states_match
from test_torch_ctr_train import bridged, jax_steps, port_steps_match

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)
SLOTS = tuple(str(3000 + i) for i in range(12))
KW = dict(slots=SLOTS, bias_slots=SLOTS[:4], bucket_size=256)


@pytest.fixture(scope="module")
def pair():
    """(JAX bundle, port bundle), the JAX package's defaults but for the
    slots and buckets."""
    return jax_create_model("finish", **KW), create_model("finish", device="cpu", **KW)


def test_deepfm_layer_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 144)).astype(np.float32)
    do = rng.standard_normal((16, 1)).astype(np.float32)
    jlayer = JaxDeepFMLayer()
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want, vjp = jax.vjp(lambda p, v: jlayer.apply({"params": p}, v), params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(do))
    layer = DeepFMLayer(144)
    flat = bridge._flatten(jax.tree.map(np.asarray, params))
    assert set(flat) == {n for n, _ in layer.named_parameters()}
    with torch.no_grad():
        for n, p in layer.named_parameters():
            p.copy_(torch.tensor(flat[n]))
    xt = torch.tensor(x, requires_grad=True)
    got = layer(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad(got, [xt] + [p for _, p in layer.named_parameters()],
                                torch.from_numpy(do))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx), rtol=1e-5, atol=1e-6)
    want_g = bridge._flatten(jax.tree.map(np.asarray, gp))
    for n, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), want_g[n], rtol=1e-5, atol=1e-5, err_msg=n)


def test_glorot_normal_init_has_flax_scale():
    """The factor matrix: N(0, 1) cut at +-2 and scaled so that its std is
    sqrt(2 / (in + out)), as flax's ``glorot_normal``."""
    shape = (528, 8)
    want = np.asarray(JaxDeepFMLayer().init(jax.random.PRNGKey(0),
                                            jnp.ones((1, shape[0])))["params"]["weight"])
    layer = DeepFMLayer(shape[0])
    layer.reset_parameters(torch.Generator().manual_seed(0))
    got = layer.weight.detach().numpy()
    bound = 2 * (2 / sum(shape)) ** 0.5 / 0.87962566103423978
    for w in (got, want):
        assert np.abs(w).max() <= bound
        assert abs(w.std() - (2 / sum(shape)) ** 0.5) < 0.03 * (2 / sum(shape)) ** 0.5


def test_bridge_predict_and_service_match_jax(pair):
    jbundle, pbundle = pair
    (jstate, *_), (pstate, *_) = bridged(jbundle, pbundle, key=1)
    flat = bridge._flatten(jax.tree.map(np.asarray, jstate.params))
    assert set(flat) == set(pstate.params)
    assert {"fm.weight", "fm.deeepfmlinear.kernel", "bais_dnn_one_1.kernel",
            "bais_dnn_two_3.kernel", "pred.kernel"} <= set(flat)
    assert flat["dnn_0.kernel"].shape == (144, 64) and flat["pred.kernel"].shape == (33, 1)
    assert pbundle.embedding.storage == jbundle.embedding.storage
    jb, _, _, _ = jax_synthetic_batch(jbundle, 40, seed=9)
    pb, _, _, _ = synthetic_batch(pbundle, 40, seed=9)
    want = jax_make_predict_step(jbundle)(jstate, jb, None)
    got = make_predict_step(pbundle)(pstate, pb)
    assert set(got) == set(want) == {TASK}
    np.testing.assert_allclose(got[TASK].numpy(), np.asarray(want[TASK]), **TOL)

    rng = np.random.default_rng(4)
    rows = [{s: [int(x) for x in rng.integers(0, 1 << 40, rng.integers(1, 6))]
             for s in SLOTS if rng.uniform() < 0.8} for _ in range(9)] + [{}]
    want = JaxScoringService(jbundle, jstate, max_batch=16).score(rows)
    svc = ScoringService(pbundle, pstate, max_batch=16, device="cpu")
    got = svc.score(rows)
    np.testing.assert_allclose(got[TASK], want[TASK], **TOL)
    assert 0.0 < min(got[TASK]) and max(got[TASK]) < 1.0
    np.testing.assert_allclose(svc.score(rows[3:4])[TASK][0], got[TASK][3], **TOL)


def test_three_steps_match_jax(pair):
    jbundle, pbundle = pair
    jside, pside = bridged(jbundle, pbundle)
    jstate, jinfos = jax_steps(jbundle, jside)
    _assert_states_match(jbundle, jstate, port_steps_match(pbundle, pside, jinfos))


def test_server_builds_finish_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_server.main(["--model", "finish"])
