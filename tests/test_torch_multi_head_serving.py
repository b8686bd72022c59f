"""The port's multi_head scoring path against the JAX package: synthetic
batches and the seven labels, the predict step (its InteractingLayer
through K6) against the JAX step under its default backend and under
``set_backend("pallas")``, the scoring service, the per-sample loss, the truncated-normal experts' init
(held to flax's scale), and the train step's admission of the L1L2-regularized tower
(``tests/test_torch_multi_head_train.py`` holds its steps to JAX).

Configuration: 6 slots of dim 8 over 256-id buckets.  Tolerance rtol 1e-5,
atol 2e-6: float32 products summed in another order by XLA-CPU and
torch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.kernels import set_backend
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.serving import ScoringService as JaxScoringService
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train import losses as jax_losses
from recommendsystem_tpu.train.step import make_predict_step as jax_make_predict_step
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.multi_head import TASKS
from recommendsystem_tpu_torch.nn import Dense, regularized_kernels, truncated_normal
from recommendsystem_tpu_torch.nn import interacting as nn_interacting
from recommendsystem_tpu_torch.serving import ScoringService
from recommendsystem_tpu_torch.train import (create_train_state, losses, make_predict_step,
                                             make_train_step)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)
SLOTS = tuple(str(2000 + i) for i in (5, 0, 3, 1, 4, 2))       # sorted by the factory
BUCKET = 256


@pytest.fixture(scope="module")
def pair():
    """(JAX bundle, JAX state, (port bundle, port state))."""
    jbundle = jax_create_model("multi_head", slots=SLOTS, bucket_size=BUCKET)
    jbatch, _, _, _ = jax_synthetic_batch(jbundle, 8, seed=0)
    jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(3), jbatch)
    params = jax.tree.map(np.asarray, jstate.params)
    tables = {k: np.asarray(v) for k, v in jbundle.embedding.weights(jstate.tables).items()}
    pbundle = create_model("multi_head", slots=SLOTS, bucket_size=BUCKET, device="cpu")
    return jbundle, jstate, (pbundle, bridge.from_jax_numpy(pbundle, params, tables))


def test_bridge_carries_every_flax_key(pair):
    jbundle, jstate, (pbundle, pstate) = pair
    flat = bridge._flatten(jax.tree.map(np.asarray, jstate.params))
    assert set(flat) == set(pstate.params) == {k for k, _ in pbundle.module.named_parameters()}
    assert len(flat) == 10 + 2 * (2 + 8 + 7 + 7)
    assert pbundle.module.slots == tuple(sorted(SLOTS))
    assert pbundle.embedding.storage == jbundle.embedding.storage


@pytest.mark.parametrize("ids_per_feature", [5, 1])
def test_synthetic_batch_matches_jax_to_the_byte(pair, ids_per_feature):
    jbundle, _, ports = pair
    jb, _, jl, jw = jax_synthetic_batch(jbundle, 24, seed=6, ids_per_feature=ids_per_feature)
    pb, _, pl, pw = synthetic_batch(ports[0], 24, seed=6,
                                    ids_per_feature=ids_per_feature)
    assert set(pb) == set(jb) == set(SLOTS)
    for k in jb:
        for a, w in ((pb[k].rows.numpy(), jb[k].rows), (pb[k].mask.numpy(), jb[k].mask)):
            assert a.dtype == w.dtype and a.tobytes() == w.tobytes(), k
    assert list(pl) == list(jl) == list(TASKS)
    for k in jl:
        assert pl[k].numpy().dtype == jl[k].dtype and pl[k].numpy().tobytes() == jl[k].tobytes()
    assert pw.numpy().tobytes() == jw.tobytes()


@pytest.mark.parametrize("backend", [None, "pallas"])
def test_predict_step_matches_jax(pair, backend, monkeypatch):
    jbundle, jstate, (pbundle, pstate) = pair
    calls = []
    real = nn_interacting.interacting_attention
    monkeypatch.setattr(nn_interacting, "interacting_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jb, _, _, _ = jax_synthetic_batch(jbundle, 40, seed=12)
    pb, _, _, _ = synthetic_batch(pbundle, 40, seed=12)
    set_backend(backend)
    try:
        want = jax_make_predict_step(jbundle)(jstate, jb, None)
    finally:
        set_backend(None)
    got = make_predict_step(pbundle)(pstate, pb)
    assert len(calls) == 1
    assert set(got) == set(want) == set(TASKS)
    for k in got:
        assert got[k].shape == (40, 1)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
        assert 0.0 < float(got[k].min()) and float(got[k].max()) < 1.0


def test_score_matches_jax_service(pair):
    jbundle, jstate, ports = pair
    rng = np.random.default_rng(9)
    rows = [{s: [int(x) for x in rng.integers(0, 1 << 40, rng.integers(1, 6))]
             for s in SLOTS if rng.uniform() < 0.8} for _ in range(9)] + [{}]
    want = JaxScoringService(jbundle, jstate, max_batch=16).score(rows)
    got = ScoringService(*ports, max_batch=16, device="cpu").score(rows)
    assert set(got) == set(want) == set(TASKS)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_cross_entropy_per_sample_matches_jax():
    rng = np.random.default_rng(1)
    y = (rng.uniform(size=(32, 1)) < 0.3).astype(np.float32)
    p = rng.uniform(0.0, 1.0, (32, 1)).astype(np.float32)
    p[0, 0] = 1.0
    want = jax.jit(jax_losses.cross_entropy_per_sample)(jnp.asarray(y), jnp.asarray(p))
    got = losses.cross_entropy_per_sample(torch.from_numpy(y), torch.from_numpy(p))
    assert got.shape == (32, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_truncated_normal_init_and_seeded_state():
    """``truncated_normal(0.001)`` as flax's: N(0, 1) cut at +-2 times
    0.001, so values within +-0.002 and a std of 0.00088, the std of
    flax's own draw of the same shape."""
    import flax.linen as fnn

    want = np.asarray(fnn.initializers.truncated_normal(stddev=0.001)(
        jax.random.PRNGKey(0), (2000, 32)))
    dense = Dense(2000, 32, kernel_init=truncated_normal(0.001))
    dense.reset_parameters(torch.Generator().manual_seed(0))
    w = dense.kernel.detach()
    assert float(w.abs().max()) <= 2 * 0.001 and float(np.abs(want).max()) <= 2 * 0.001
    assert abs(float(w.std()) - 0.001 * 0.87962566103423978) < 5e-6
    assert abs(float(w.std()) - float(want.std())) < 5e-6
    assert not dense.bias.any()
    bundle = create_model("multi_head", slots=SLOTS, bucket_size=BUCKET, device="cpu")
    a, b = create_train_state(bundle, 4), create_train_state(bundle, 4)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    expert = a.params["expert_0_fc1.kernel"]
    assert float(expert.abs().max()) <= 2 * 0.001


def test_states_of_one_bundle_share_no_tensor():
    """A second state of a bundle, or a change to one state's params, leaves
    the first state as it was (as two JAX states are independent)."""
    bundle = create_model("multi_head", slots=SLOTS, bucket_size=BUCKET, device="cpu")
    a = create_train_state(bundle, 1)
    before = {k: v.clone() for k, v in a.params.items()}
    b = create_train_state(bundle, 2)
    for v in b.params.values():
        v.add_(1.0)
    for name, p in bundle.module.named_parameters():
        with torch.no_grad():
            p.zero_()
    for k, v in a.params.items():
        assert torch.equal(v, before[k]), k


def test_train_step_refuses_modes_other_than_local(pair):
    """The tower of regularized experts, gates and deep layers is refused in
    any mode but "local"; its ``stacked_experts`` variant builds the 8
    experts as one stacked Dense ``experts_fc1`` and scores as the JAX
    stacked model does."""
    pbundle = pair[2][0]
    assert pbundle.module.expert_0_fc1.kernel_regularizer == (0.0, 0.01)
    assert pbundle.module.dnn_0.kernel_regularizer == (1e-5, 1e-5)
    with pytest.raises(NotImplementedError, match="mode 'sharded'"):
        make_train_step(pbundle, mode="sharded")
    jbundle = jax_create_model("multi_head", slots=SLOTS, bucket_size=BUCKET,
                               stacked_experts=True)
    sbundle = create_model("multi_head", slots=SLOTS, bucket_size=BUCKET,
                           stacked_experts=True, device="cpu")
    jbatch, _, _, _ = jax_synthetic_batch(jbundle, 8, seed=0)
    jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(4), jbatch)
    sstate = bridge.from_jax_numpy(
        sbundle, jax.tree.map(np.asarray, jstate.params),
        {k: np.asarray(v) for k, v in jbundle.embedding.weights(jstate.tables).items()})
    assert sstate.params["experts_fc1.kernel"].shape[0] == 8
    assert regularized_kernels(sbundle.module)[(0.0, 0.01)][0] == "experts_fc1.kernel"
    jb, _, _, _ = jax_synthetic_batch(jbundle, 24, seed=9)
    pb, _, _, _ = synthetic_batch(sbundle, 24, seed=9)
    want = jax_make_predict_step(jbundle)(jstate, jb, None)
    got = make_predict_step(sbundle)(sstate, pb)
    assert set(got) == set(want) == set(TASKS)
    for t in TASKS:
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]), err_msg=t, **TOL)


def test_train_step_takes_the_regularized_tower(pair):
    """In the local mode the step takes the tower and penalizes the eight
    experts' first kernels (the unused eighth too) and the seven gates with
    L2 0.01, and the deep tower with L1L2 1e-5."""
    pbundle = pair[2][0]
    groups = regularized_kernels(pbundle.module)
    assert set(groups) == {(0.0, 0.01), (1e-5, 1e-5)}
    assert "expert_7_fc1.kernel" in groups[(0.0, 0.01)]
    assert sum(len(v) for v in groups.values()) == len(
        [m for m in pbundle.module.modules() if getattr(m, "kernel_regularizer", None)])
    assert callable(make_train_step(pbundle))


def test_default_widths_match_jax():
    """40 slots 2000..2039 of dim 8 over 265,000-id buckets, grouped into
    storages of at most 10 MB, as the JAX engine groups them; F = 40."""
    pbundle = create_model("multi_head", device="cpu")
    jbundle = jax_create_model("multi_head")
    assert pbundle.embedding.storage == jbundle.embedding.storage
    assert pbundle.embedding.table_map == jbundle.embedding.table_map
    assert len(pbundle.module.slots) == 40
    assert pbundle.module.dnn_0.kernel.shape == (320, 32)
