"""The port's packed train step on multi_head against the JAX package's.

3 steps from the bridged state (as ``tests/test_torch_ctr_train.py``), 6
slots of dim 8 over 256-id buckets, B = 32, with sample weights drawn from
a seed (the per-sample losses are their weighted means) and the L1L2
penalties of the deep tower, the eight experts and the seven gates.  The
JAX module hard-codes attention dropout 0.2: here its InteractingLayer is
swapped, in this test only, for a subclass that applies itself with
``training=False``, and the port layer's ``use_dropout`` is set to False
(the two packages draw other dropout bits).  The eighth expert is built
but never used: its bias gets no gradient and stays as it was, its kernel
moves by its L2 penalty alone, as in JAX.  Tolerances as
``tests/test_torch_autoint_train.py``; the eighth expert's kernel moves by
the JAX step's amount within rtol 1e-4 (an Adam step of lr 1e-5 on a
gradient 0.02 K, K ~ 1e-3).
"""

import jax
import numpy as np
import torch

import recommendsystem_tpu.nn as jax_nn
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.nn.interacting import InteractingLayer as JaxInteractingLayer
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.multi_head import TASKS
from test_torch_autoint_train import _assert_states_match, _flat
from test_torch_ctr_train import BATCH, bridged, jax_steps, port_steps_match

torch.set_num_threads(1)
SLOTS = tuple(str(2000 + i) for i in range(6))
BUCKET = 256


class _EvalInteractingLayer(JaxInteractingLayer):
    def __call__(self, inputs, training=False):
        return super().__call__(inputs, training=False)


def test_three_weighted_steps_match_jax(monkeypatch):
    monkeypatch.setattr(jax_nn, "InteractingLayer", _EvalInteractingLayer)
    jbundle = jax_create_model("multi_head", slots=SLOTS, bucket_size=BUCKET)
    pbundle = create_model("multi_head", slots=SLOTS, bucket_size=BUCKET, device="cpu")
    pbundle.module.interacting.use_dropout = False
    weight = np.random.default_rng(11).uniform(0.25, 2.0, (BATCH, 1)).astype(np.float32)
    jside, pside = bridged(jbundle, pbundle)
    before = {k: v.clone() for k, v in pside[0].params.items()}
    jstate, jinfos = jax_steps(jbundle, jside, sample_weight=weight)
    assert set(jinfos[0]) == {"loss", "regularization", *(f"loss/{t}" for t in TASKS)}
    pstate = port_steps_match(pbundle, pside, jinfos, sample_weight=torch.from_numpy(weight))
    _assert_states_match(jbundle, jstate, pstate)

    # the eighth expert: a bias outside the graph, a kernel moved by L2 alone
    jparams = _flat(jax.device_get(jstate.params))
    bias, kernel = "expert_7_fc1.bias", "expert_7_fc1.kernel"
    assert torch.equal(pstate.params[bias], before[bias])
    np.testing.assert_array_equal(jparams[bias], before[bias].numpy())
    assert not pstate.opt_state["mu"][bias].any() and not pstate.opt_state["nu"][bias].any()
    moved = (pstate.params[kernel] - before[kernel]).numpy()
    assert np.all(moved != 0.0)
    np.testing.assert_allclose(moved, jparams[kernel] - before[kernel].numpy(), rtol=1e-4)

