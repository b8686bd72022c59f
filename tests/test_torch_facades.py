"""The port's namespace facades against the JAX package's: ``ops`` (every
public name of ``nn`` plus ``din_pool`` and ``interacting_attention``, and
no backend switch), the ``kernels`` exports, ``train.total_loss_fn`` (loss,
task losses, regularization and the dense gradients against the JAX
function from bridged state, rtol 1e-5) and ``Feature``/``FeatureSlot``
(sorting and comparing as the JAX ones do)."""

import jax
import numpy as np
import pytest
import torch

import recommendsystem_tpu.embedding.feature_column as JFC
import recommendsystem_tpu.kernels as jax_kernels
import recommendsystem_tpu.ops as jax_ops
from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.models.staytime import StaytimeConfig as JaxStaytimeConfig
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train import total_loss_fn as jax_total_loss_fn
from recommendsystem_tpu_torch import bridge, kernels, nn, ops
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.embedding import Feature, FeatureSlot
from recommendsystem_tpu_torch.kernels.din import din_pool
from recommendsystem_tpu_torch.kernels.interacting import interacting_attention
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
from recommendsystem_tpu_torch.train import total_loss_fn

torch.set_num_threads(1)
RTOL = 1e-5
_STAY = dict(bucket_size=128, seq_max_len=4)
MODELS = {
    "autoint": (dict(bucket_size=256), dict(bucket_size=256)),
    "staytime": (dict(cfg=JaxStaytimeConfig(**_STAY)), dict(cfg=StaytimeConfig(**_STAY))),
}
B = 8


def test_ops_exposes_nn_and_the_kernels():
    public = {n for n in dir(nn) if not n.startswith("_")}
    assert public <= set(dir(ops))
    for n in public:
        assert getattr(ops, n) is getattr(nn, n), n
    assert ops.din_pool is din_pool and ops.interacting_attention is interacting_attention
    # the port has no backend switch
    for n in ("set_backend", "use_pallas", "interpret_mode"):
        assert hasattr(jax_ops, n) and not hasattr(ops, n), n


def test_kernels_export_what_the_jax_kernels_export():
    for n in ("din_pool", "interacting_attention"):
        assert hasattr(jax_kernels, n) and hasattr(kernels, n), n
    assert kernels.din_pool is din_pool
    assert kernels.interacting_attention is interacting_attention


def _pair(name):
    jkw, pkw = MODELS[name]
    jbundle = jax_create_model(name, **jkw)
    pbundle = create_model(name, device="cpu", **pkw)
    jb, jd, jl, jw = jax_synthetic_batch(jbundle, B, seed=2)
    jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(5), jb, dense_inputs=jd)
    jweights = jbundle.embedding.weights(jstate.tables)
    pstate = bridge.from_jax_numpy(pbundle, jax.tree.map(np.asarray, jstate.params),
                                   {k: np.asarray(v) for k, v in jweights.items()})
    pb, pd, pl, pw = synthetic_batch(pbundle, B, seed=2)
    return (jbundle, jstate.params, jweights, jb, jd, jl, jw,
            pbundle, pstate, pb, pd, pl, pw)


@pytest.mark.parametrize("name", list(MODELS))
def test_total_loss_fn_matches_jax(name):
    (jbundle, jparams, jweights, jb, jd, jl, jw,
     pbundle, pstate, pb, pd, pl, pw) = _pair(name)

    def jloss(params):
        return jax_total_loss_fn(jbundle, params, jweights, jb, jl, jw, jd, training=False)

    (jl_val, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = {k: v.detach().requires_grad_() for k, v in pstate.params.items()}
    weights = {k: t["w"] for k, t in pstate.tables.items()}
    loss, aux = total_loss_fn(pbundle, params, weights, pb, pl, pw, pd, training=False)
    np.testing.assert_allclose(float(loss.detach()), float(jl_val), rtol=RTOL)
    assert aux["regularization"].ndim == 0
    np.testing.assert_allclose(float(aux["regularization"]), float(jaux["regularization"]),
                               rtol=RTOL, atol=1e-12)
    for t, v in jaux["task_losses"].items():
        np.testing.assert_allclose(float(aux["task_losses"][t]), float(v), rtol=RTOL,
                                   err_msg=t)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                 allow_unused=True, materialize_grads=True)))
    flat = bridge._flatten(jax.tree.map(np.asarray, jgrads))
    assert set(flat) == set(grads)
    # float32 sums of the same terms in another order: each entry within
    # rtol of itself or of the largest |gradient| of the model (the DIN
    # scorer's biases have gradients near 0 in exact arithmetic)
    scale = max(float(np.abs(v).max()) for v in flat.values() if v.size)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), flat[k], rtol=RTOL, atol=RTOL * scale,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_total_loss_fn_seeds_and_modes(name):
    *_, pbundle, pstate, pb, pd, pl, pw = _pair(name)
    weights = {k: t["w"] for k, t in pstate.tables.items()}
    args = (pbundle, pstate.params, weights, pb, pl, pw, pd)
    # a torch.Generator in place of the JAX rngs draws the step seed
    a, _ = total_loss_fn(*args, seed=torch.Generator().manual_seed(3))
    b, _ = total_loss_fn(*args, seed=torch.Generator().manual_seed(3))
    assert torch.isfinite(a) and torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="sharded"):
        total_loss_fn(*args, mode="sharded")


def test_feature_and_slot_sort_and_compare_as_jax():
    ids = ["12", "3", None, "200", "3", "b", "a"]
    port = [Feature(feature_id=i, feature_slot=FeatureSlot(f"s{n}"), sparse=n % 2 == 0)
            for n, i in enumerate(ids)]
    ref = [JFC.Feature(feature_id=i, feature_slot=JFC.FeatureSlot(f"s{n}"),
                       sparse=n % 2 == 0) for n, i in enumerate(ids)]
    assert [f.feature_id for f in sorted(port)] == [f.feature_id for f in sorted(ref)]
    assert [f.slot_id for f in sorted(port)] == [f.slot_id for f in sorted(ref)]
    pairs = [(f, i) for i, f in enumerate(port)]
    jpairs = [(f, i) for i, f in enumerate(ref)]
    assert [i for _, i in sorted(pairs)] == [i for _, i in sorted(jpairs)]
    assert Feature("1", FeatureSlot("x")) == Feature("1", FeatureSlot("x"))
    assert Feature("1", FeatureSlot("x")) != Feature("1", FeatureSlot("y"))
    assert Feature().slot_id is None and JFC.Feature().slot_id is None
    assert Feature(feature_slot=FeatureSlot("7")).slot_id == "7"
    assert hash(FeatureSlot("7")) == hash(FeatureSlot("7"))
    assert {f.name for f in __import__("dataclasses").fields(Feature)} == \
        {f.name for f in __import__("dataclasses").fields(JFC.Feature)}
    with pytest.raises(Exception):
        FeatureSlot("7").slot_id = "8"
