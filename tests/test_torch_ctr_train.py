"""The port's packed train step on ctr against the JAX package's.

Both start from the same state, carried across by ``bridge.from_jax_numpy``
(dense params, optax's Adam state, the tables' classic per-row view), and
take 3 steps on one batch with attention dropout off on both sides (the two
packages draw other dropout bits): at ctr's default widths (24 slots of
48-wide rows, 5 ids a column), once with the InteractingLayer as the eval
path takes it (K6's plain version) and once through its transposed K5
path, as a training step with dropout takes it on the card; and at the
212-feature shape (``synthetic_ctr_config(num_slots=180, num_bias=32)``,
F = 180, 56-wide rows, one id a column).  The loss includes the L1L2
penalties of the six regularized Dense layers; ``regularization`` is
held to the JAX step's.  Tolerances as ``tests/test_torch_autoint_train.py``:
losses and ``regularization`` rtol 1e-5; weights atol 1e-5; moments rtol
1e-4, atol 1e-9; t and show exact.  Buckets of 256 ids, B = 32.

The batch comes from seed 4.  At seed 3 (the autoint test's) two float32
steps meet a kink: at the default widths a ReLU input of the third step
lies within rounding of 0, above it on one of the port's two paths and
below it on the other; at the 212-feature shape one sample's gradient in
the JAX step differs from a float64 run of the same step, which the port's
float32 gradient matches.  Either sends that sample's rows past the
tolerance; neither is a fault of a package.
"""

import jax
import numpy as np
import torch

from recommendsystem_tpu.core.config import synthetic_ctr_config as jax_synthetic_ctr_config
from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train.step import make_train_step as jax_make_train_step
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.core.config import synthetic_ctr_config
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.train import make_train_step
from test_torch_autoint_train import LOSS_RTOL, _assert_states_match

torch.set_num_threads(1)
BUCKET = 256
BATCH = 32


def bridged(jbundle, pbundle, ids_per_feature=5, seed=4, key=0):
    """(JAX state, batch, labels, weights), (port state, batch, labels,
    weights): a fresh JAX state, carried across whole, and one batch drawn
    alike on both sides."""
    jb, _, jl, jw = jax_synthetic_batch(jbundle, BATCH, seed=seed,
                                        ids_per_feature=ids_per_feature)
    pb, _, pl, pw = synthetic_batch(pbundle, BATCH, seed=seed,
                                    ids_per_feature=ids_per_feature)
    jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(key), jb)
    pstate = bridge.from_jax_numpy(
        pbundle, jax.tree.map(np.asarray, jstate.params),
        jax.device_get(jbundle.embedding.classic_state(jstate.tables)),
        opt_state=jax.tree.map(np.asarray, jstate.opt_state))
    return (jstate, jb, jl, jw), (pstate, pb, pl, pw)


def jax_steps(jbundle, jax_side, sample_weight=None, steps=3):
    """The JAX state after ``steps`` packed steps and each step's info."""
    jstate, jb, jl, jw = jax_side
    jstep = jax_make_train_step(jbundle, donate=False, sparse_update="packed")
    infos = []
    for i in range(steps):
        jstate, info = jstep(jstate, jb, jl, jw if sample_weight is None else sample_weight,
                             None, jax.random.PRNGKey(i))
        infos.append(jax.device_get(info))
    return jstate, infos


def port_steps_match(pbundle, port_side, jinfos, sample_weight=None):
    """Takes as many port steps as ``jinfos`` has, each step's loss,
    per-task losses and ``regularization`` held to the JAX step's; returns
    the port state.  The CPU launches no kernel."""
    pstate, pb, pl, pw = port_side
    step = make_train_step(pbundle)
    reset_launch_counts()
    for i, jinfo in enumerate(jinfos):
        pstate, pinfo = step(pstate, pb, pl, pw if sample_weight is None else sample_weight,
                             None, seed=i)
        assert set(pinfo) == set(jinfo)
        for name, want in jinfo.items():
            assert pinfo[name].ndim == 0, name
            np.testing.assert_allclose(float(pinfo[name]), float(want), rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {name}")
        assert float(pinfo["regularization"]) > 0.0
    assert pstate.step == len(jinfos)
    assert set(launch_counts().values()) == {0}
    return pstate


def test_three_steps_match_jax_at_default_widths(monkeypatch):
    jbundle = jax_create_model("ctr", bucket_size=BUCKET, attention_dropout_rate=0.0)
    pbundle = create_model("ctr", bucket_size=BUCKET, attention_dropout_rate=0.0,
                           device="cpu")
    assert {d for _, d in pbundle.embedding.storage.values()} == {48}
    jside, pside = bridged(jbundle, pbundle)
    jstate, jinfos = jax_steps(jbundle, jside)
    _assert_states_match(jbundle, jstate, port_steps_match(pbundle, pside, jinfos))
    # the same steps through the layer's transposed K5 path
    layer = pbundle.module.interacting
    monkeypatch.setattr(layer, "forward", layer.forward_transposed)
    _, pside = bridged(jbundle, pbundle)
    _assert_states_match(jbundle, jstate, port_steps_match(pbundle, pside, jinfos))


def test_three_steps_match_jax_at_the_212_feature_shape():
    jbundle = jax_create_model("ctr", cfg=jax_synthetic_ctr_config(num_slots=180, num_bias=32),
                               bucket_size=BUCKET, attention_dropout_rate=0.0)
    pbundle = create_model("ctr", cfg=synthetic_ctr_config(num_slots=180, num_bias=32),
                           bucket_size=BUCKET, attention_dropout_rate=0.0, device="cpu")
    assert sum(1 for n, _ in pbundle.module.named_children()
               if n.startswith("emb_linear_map_")) == 180
    assert {d for _, d in pbundle.embedding.storage.values()} == {56}
    jside, pside = bridged(jbundle, pbundle, ids_per_feature={})
    assert all(v.rows.shape == (BATCH, 1) for v in pside[1].values())
    jstate, jinfos = jax_steps(jbundle, jside)
    _assert_states_match(jbundle, jstate, port_steps_match(pbundle, pside, jinfos))

