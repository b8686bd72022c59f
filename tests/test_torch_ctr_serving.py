"""The port's ctr scoring path against the JAX package: synthetic batches
and labels, the predict step (its InteractingLayer through K6) against the
JAX step under its default backend and under ``set_backend("pallas")``,
the scoring service, and ``production_ctr`` on a small
``model_parameter.json``-shaped dict, with weights carried by
``bridge.from_jax_numpy``; the train step's admission of the
L1L2-regularized tower (``tests/test_torch_ctr_train.py`` holds its steps
to JAX) and its refusal of the modes not ported.

Configuration: ``synthetic_ctr_config(num_slots=8, num_bias=4)`` (F = 8,
rows of the widest slot's total emb size, one bias feature of each type)
over 256-id buckets.  Tolerance rtol 1e-5, atol 2e-6: float32 products
summed in another order by XLA-CPU and torch."""

import jax
import numpy as np
import pytest
import torch

from recommendsystem_tpu.core.config import synthetic_ctr_config as jax_synthetic_ctr_config
from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.kernels import set_backend
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.models.ctr import production_ctr as jax_production_ctr
from recommendsystem_tpu.serving import ScoringService as JaxScoringService
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train.step import make_predict_step as jax_make_predict_step
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.core.config import synthetic_ctr_config
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.ctr import (REFERENCE_GATE_SLOTS, T_CLICK, T_EFFECT,
                                                  production_ctr)
from recommendsystem_tpu_torch.nn import interacting as nn_interacting
from recommendsystem_tpu_torch.nn import regularized_kernels
from recommendsystem_tpu_torch.serving import ScoringService
from recommendsystem_tpu_torch.serving import server as port_server
from recommendsystem_tpu_torch.train import make_predict_step, make_train_step

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)
SMALL = dict(num_slots=8, num_bias=4)
BUCKET = 256


def _bridged(jbundle, pbundle, key):
    """(JAX state, port state): a JAX state, and its params and tables
    carried into the port."""
    jbatch, _, _, _ = jax_synthetic_batch(jbundle, 8, seed=0)
    jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(key), jbatch)
    params = jax.tree.map(np.asarray, jstate.params)
    tables = {k: np.asarray(v) for k, v in jbundle.embedding.weights(jstate.tables).items()}
    return jstate, bridge.from_jax_numpy(pbundle, params, tables)


@pytest.fixture(scope="module")
def pair():
    """(JAX bundle, JAX state, (port bundle, port state))."""
    jbundle = jax_create_model("ctr", cfg=jax_synthetic_ctr_config(**SMALL),
                               bucket_size=BUCKET)
    pbundle = create_model("ctr", cfg=synthetic_ctr_config(**SMALL), bucket_size=BUCKET,
                           device="cpu")
    jstate, pstate = _bridged(jbundle, pbundle, 2)
    return jbundle, jstate, (pbundle, pstate)


def _predict_matches_jax(jbundle, jstate, pbundle, pstate, seed, backend, monkeypatch):
    """The port's predict step, with K6 called once, against the JAX step
    under ``backend``."""
    calls = []
    real = nn_interacting.interacting_attention
    monkeypatch.setattr(nn_interacting, "interacting_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jb, _, _, _ = jax_synthetic_batch(jbundle, 40, seed=seed)
    pb, _, _, _ = synthetic_batch(pbundle, 40, seed=seed)
    set_backend(backend)
    try:
        want = jax_make_predict_step(jbundle)(jstate, jb, None)
    finally:
        set_backend(None)
    got = make_predict_step(pbundle)(pstate, pb)
    assert len(calls) == 1
    assert set(got) == set(want) == {T_CLICK, T_EFFECT}
    for k in got:
        assert got[k].shape == (40, 1)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
        assert float(got[k].min()) >= 1e-6 and float(got[k].max()) <= 1.0


def test_bridge_carries_every_flax_key(pair):
    jbundle, jstate, (pbundle, pstate) = pair
    flat = bridge._flatten(jax.tree.map(np.asarray, jstate.params))
    assert set(flat) == set(pstate.params) == {k for k, _ in pbundle.module.named_parameters()}
    assert len(flat) == 2 * (2 + 8 + 1 + 2 + 1 + 3 * 2 * 3 + 2 * 3 + 2 * 3) + 10
    for k, v in flat.items():
        assert torch.equal(pstate.params[k], torch.from_numpy(v.copy())), k
    assert pbundle.embedding.storage == jbundle.embedding.storage


@pytest.mark.parametrize("ids_per_feature", [5, 1])
def test_synthetic_batch_matches_jax_to_the_byte(pair, ids_per_feature):
    jbundle, _, ports = pair
    jb, _, jl, jw = jax_synthetic_batch(jbundle, 24, seed=5, ids_per_feature=ids_per_feature)
    pb, _, pl, pw = synthetic_batch(ports[0], 24, seed=5,
                                    ids_per_feature=ids_per_feature)
    assert set(pb) == set(jb) and len(pb) == 8
    for k in jb:
        for a, w in ((pb[k].rows.numpy(), jb[k].rows), (pb[k].mask.numpy(), jb[k].mask)):
            assert a.dtype == w.dtype and a.tobytes() == w.tobytes(), k
    assert list(pl) == list(jl) == [T_CLICK, T_EFFECT]
    for k in jl:
        assert pl[k].numpy().dtype == jl[k].dtype and pl[k].numpy().tobytes() == jl[k].tobytes()
    assert pw.numpy().tobytes() == jw.tobytes()


@pytest.mark.parametrize("backend", [None, "pallas"])
def test_predict_step_matches_jax(pair, backend, monkeypatch):
    jbundle, jstate, (pbundle, pstate) = pair
    _predict_matches_jax(jbundle, jstate, pbundle, pstate, 11, backend, monkeypatch)


def _rows(rng, n):
    return [{str(1000 + s): [int(x) for x in rng.integers(0, 1 << 40, rng.integers(1, 6))]
             for s in range(8) if rng.uniform() < 0.8} for _ in range(n)]


def test_score_matches_jax_service(pair):
    jbundle, jstate, ports = pair
    rows = _rows(np.random.default_rng(4), 9) + [{}]
    want = JaxScoringService(jbundle, jstate, max_batch=16).score(rows)
    psvc = ScoringService(*ports, max_batch=16, device="cpu")
    got = psvc.score(rows)
    assert set(got) == set(want) == {T_CLICK, T_EFFECT}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    alone = psvc.score(rows[3:4])                               # bucket 8 against 16
    for k in got:
        np.testing.assert_allclose(alone[k][0], got[k][3], **TOL)


def test_train_step_refuses_modes_other_than_local(pair):
    """The tower of six L1L2-regularized Dense layers; the step refuses
    the sharded mode without a mesh, and any mode but "local" and
    "sharded"."""
    pbundle = pair[2][0]
    regularized = [n for n, m in pbundle.module.named_modules()
                   if getattr(m, "kernel_regularizer", None) == (1e-5, 1e-5)]
    assert regularized == ["dnn_0", "dnn_1", "task0_dnn2_0", "task0_dnn2_1",
                           "task1_dnn2_0", "task1_dnn2_1"]
    with pytest.raises(ValueError, match="mode 'sharded' needs a mesh"):
        make_train_step(pbundle, mode="sharded")
    with pytest.raises(ValueError, match="mode 'pipeline'"):
        make_train_step(pbundle, mode="pipeline")


def test_train_step_takes_the_regularized_tower(pair):
    """In the local mode the step takes the tower and penalizes the six
    kernels, all with one coefficient pair."""
    pbundle = pair[2][0]
    assert regularized_kernels(pbundle.module) == {(1e-5, 1e-5): [
        f"{n}.kernel" for n in ("dnn_0", "dnn_1", "task0_dnn2_0", "task0_dnn2_1",
                                "task1_dnn2_0", "task1_dnn2_1")]}
    assert callable(make_train_step(pbundle))


def test_default_widths_match_jax():
    """The default ctr: 24 slots of 48-wide rows over 265,000-id buckets in
    storages of one table each, F = 24, the same parameter shapes."""
    pbundle = create_model("ctr", device="cpu")
    jbundle = jax_create_model("ctr")
    assert pbundle.embedding.storage == jbundle.embedding.storage
    assert len(pbundle.embedding.storage) == 24
    assert {d for _, d in pbundle.embedding.storage.values()} == {48}
    assert pbundle.module.interacting.wq.shape == (8, 8)
    assert sum(1 for n in pbundle.module.state_dict() if n.startswith("emb_linear_map_")) == 48
    assert pbundle.module.ppnet.dnn_ppnet_gate.kernel.shape[1] == 704


def test_stacked_experts_match_jax(monkeypatch):
    """``stacked_experts=True`` builds the MMoE's three gated experts as
    one stack (``experts.*``, kernels (3, in, out), as the
    JAX ``stacked_gated_experts`` leaves them), and the predict step matches
    the JAX stacked model's (``tests/test_torch_stacked_experts.py`` trains
    it)."""
    jbundle = jax_create_model("ctr", cfg=jax_synthetic_ctr_config(**SMALL),
                               bucket_size=BUCKET, stacked_experts=True)
    pbundle = create_model("ctr", cfg=synthetic_ctr_config(**SMALL), bucket_size=BUCKET,
                           stacked_experts=True, device="cpu")
    jstate, pstate = _bridged(jbundle, pbundle, 5)
    assert pstate.params["experts.expert_output_1.kernel"].shape == (3, 512, 256)
    assert not any(k.startswith("expert_output_") for k in pstate.params)
    _predict_matches_jax(jbundle, jstate, pbundle, pstate, 6, None, monkeypatch)


def test_server_builds_ctr_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_server.main(["--model", "ctr", "--bucket-size", "256"])


def _model_parameter():
    """A ``model_parameter.json``-shaped dict: twelve slots, five of them in
    ``REFERENCE_GATE_SLOTS``, one shared by two features, the four bias
    types on four slots, and a ``featureid_to_slot`` remap onto one table."""
    slots = ["1568", "1570", "1578", "2039", "3303", "1001", "1002", "1003",
             "1004", "1005", "1006", "1007"]
    sparse = {f"feat_{s}": {"emb_size": 8 if i % 2 else 12, "slot_id": [s]}
              for i, s in enumerate(slots)}
    sparse["feat_1568_b"] = {"emb_size": 16, "slot_id": ["1568"]}
    for i, bias_type in enumerate(("ppnet", "multiply_user", "multiply_item", "can")):
        sparse[f"bias_{bias_type}"] = {"emb_size": 8, "slot_id": [slots[5 + i]], "bias": 1,
                                       "bias_type": bias_type}
    return {"feature_slot": {"sparse_feature": sparse, "sequence_feature": {},
                             "dense_feature": {}},
            "featureid_to_slot": {"1007": "1006"}}


def test_production_ctr_matches_jax(monkeypatch):
    """``production_ctr`` on a parsed dict: the reference gate slots, the
    same tables and parameter shapes, and the same predictions as the JAX
    ``production_ctr`` on the same dict."""
    raw = _model_parameter()
    jbundle = jax_production_ctr(raw, bucket_size=BUCKET)
    pbundle = production_ctr(raw, bucket_size=BUCKET, device="cpu")
    assert pbundle.module.gate_slots == REFERENCE_GATE_SLOTS
    assert pbundle.embedding.storage == jbundle.embedding.storage
    assert pbundle.embedding.table_map == jbundle.embedding.table_map
    # the gate slots present: 1568 (two features), 1570, 1578, 2039 and 3303
    gate_width = (12 + 16) + 8 + 12 + 8 + 12
    assert pbundle.module.gate_0_0_1.kernel.shape == (gate_width, 512)
    jstate, pstate = _bridged(jbundle, pbundle, 5)
    flat = bridge._flatten(jax.tree.map(np.asarray, jstate.params))
    assert {k: v.shape for k, v in flat.items()} == \
        {k: tuple(p.shape) for k, p in pbundle.module.named_parameters()}
    _predict_matches_jax(jbundle, jstate, pbundle, pstate, 13, None, monkeypatch)
