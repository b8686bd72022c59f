"""The stacked-expert variants of ctr and multi_head trained by the port
against the JAX package: 3 packed steps from bridged state (as
``tests/test_torch_ctr_train.py`` and ``tests/test_torch_multi_head_train.py``),
the L2 penalty of a stacked kernel summed over its experts as the JAX step
sums the stacked sown leaf.  Their scores, and staytime's, are held to the
JAX stacked models in ``tests/test_torch_{ctr,multi_head,staytime}_serving.py``.

Configurations: ctr ``synthetic_ctr_config(num_slots=8, num_bias=4)`` over
256-id buckets, attention dropout 0; multi_head 6 slots of dim 8 over
256-id buckets, its JAX InteractingLayer applied in eval mode and the port
layer's dropout off (as the multi_head train test does).  B = 32, seed 4.
Tolerances as ``tests/test_torch_autoint_train.py``.
"""

import numpy as np
import torch

import recommendsystem_tpu.nn as jax_nn
from recommendsystem_tpu.core.config import synthetic_ctr_config as jax_synthetic_ctr_config
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu_torch.core.config import synthetic_ctr_config
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.nn import regularized_kernels
from test_torch_autoint_train import _assert_states_match
from test_torch_ctr_train import bridged, jax_steps, port_steps_match
from test_torch_multi_head_train import _EvalInteractingLayer

torch.set_num_threads(1)
BUCKET = 256


def test_stacked_ctr_three_steps_match_jax():
    kw = dict(bucket_size=BUCKET, attention_dropout_rate=0.0, stacked_experts=True)
    jbundle = jax_create_model("ctr", cfg=jax_synthetic_ctr_config(num_slots=8, num_bias=4),
                               **kw)
    pbundle = create_model("ctr", cfg=synthetic_ctr_config(num_slots=8, num_bias=4),
                           device="cpu", **kw)
    assert not any(k.startswith("experts.") for ks in
                   regularized_kernels(pbundle.module).values() for k in ks)
    jside, pside = bridged(jbundle, pbundle)
    jstate, jinfos = jax_steps(jbundle, jside)
    _assert_states_match(jbundle, jstate, port_steps_match(pbundle, pside, jinfos))


def test_stacked_multi_head_three_steps_match_jax(monkeypatch):
    monkeypatch.setattr(jax_nn, "InteractingLayer", _EvalInteractingLayer)
    slots = tuple(str(2000 + i) for i in range(6))
    jbundle = jax_create_model("multi_head", slots=slots, bucket_size=BUCKET,
                               stacked_experts=True)
    pbundle = create_model("multi_head", slots=slots, bucket_size=BUCKET,
                           stacked_experts=True, device="cpu")
    pbundle.module.interacting.use_dropout = False
    # the stacked kernel of all 8 experts (the eighth unused) carries L2 0.01
    assert pbundle.module.experts_fc1.kernel.shape[0] == 8
    assert "experts_fc1.kernel" in regularized_kernels(pbundle.module)[(0.0, 0.01)]
    jside, pside = bridged(jbundle, pbundle)
    jstate, jinfos = jax_steps(jbundle, jside)
    pstate = port_steps_match(pbundle, pside, jinfos)
    _assert_states_match(jbundle, jstate, pstate)
    # the eighth expert's bias is outside the graph: its moments stay 0
    for moment in ("mu", "nu"):
        np.testing.assert_array_equal(
            pstate.opt_state[moment]["experts_fc1.bias"][7].numpy(), 0)
