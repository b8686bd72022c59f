"""The port's rough_rank against the JAX package's: synthetic labels, the
factory's storages, the bridge of the whole flax tree, the predict step
and the scoring service with the dense flag ``4575`` at 0, at 1 and mixed,
and 3 packed train steps from bridged state at 5 ids and at 1 id (1 id puts
the grouped K4's plain version on the path); the same with
``stacked_experts``.

Configuration: 4 user slots ``1560..1563`` and 3 item slots ``1591..1593``
of dim 16 over 256-id buckets, the JAX defaults otherwise (PLE of 4 + 4
experts of DNN(32), CrossNet(2), sparse Adam 1e-3, dense Adam 1e-4);
B 32.  The batch seed (5) was fixed before the first run.  Tolerances:
scores rtol 1e-5, atol 2e-6; the train step's as
``tests/test_torch_autoint_train.py`` (losses rtol 1e-5, weights atol
1e-5, moments rtol 1e-4 / atol 1e-9, t and show exact).
"""

import jax
import numpy as np
import pytest
import torch

from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.serving import ScoringService as JaxScoringService
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train.step import make_predict_step as jax_make_predict_step
from recommendsystem_tpu.train.step import make_train_step as jax_make_train_step
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.rough_rank import FLAG_SLOT
from recommendsystem_tpu_torch.models.rough_rank_config import (ITEM_FEATURE_IDS,
                                                                USER_FEATURE_IDS)
from recommendsystem_tpu_torch.serving import ScoringService
from recommendsystem_tpu_torch.serving import server as port_server
from recommendsystem_tpu_torch.train import make_predict_step, make_train_step
from test_torch_autoint_train import LOSS_RTOL, _assert_states_match

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)
USER = tuple(str(s) for s in range(1560, 1564))
ITEM = tuple(str(s) for s in range(1591, 1594))
KW = dict(user_slots=USER, item_slots=ITEM, bucket_size=256)
BATCH = 32
SEED = 5
SERVED = ("student", "teacher", "user_emb", "item_emb")


def _pair(**kw):
    return (jax_create_model("rough_rank", **KW, **kw),
            create_model("rough_rank", device="cpu", **KW, **kw))


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _bridged(jbundle, pbundle, ids_per_feature=5, key=0):
    jb, jd, jl, jw = jax_synthetic_batch(jbundle, BATCH, seed=SEED,
                                         ids_per_feature=ids_per_feature)
    pb, pd, pl, pw = synthetic_batch(pbundle, BATCH, seed=SEED,
                                     ids_per_feature=ids_per_feature)
    jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(key), jb, dense_inputs=jd)
    pstate = bridge.from_jax_numpy(
        pbundle, jax.tree.map(np.asarray, jstate.params),
        jax.device_get(jbundle.embedding.classic_state(jstate.tables)),
        opt_state=jax.tree.map(np.asarray, jstate.opt_state))
    return (jstate, jb, jd, jl, jw), (pstate, pb, pd, pl, pw)


def test_labels_and_flag_are_the_jax_packages(pair):
    """The distillation head's labels are zeros and draw nothing, so every
    label, the flag and the ids equal the JAX package's at one seed."""
    jbundle, pbundle = pair
    jb, jd, jl, jw = jax_synthetic_batch(jbundle, BATCH, seed=SEED)
    pb, pd, pl, pw = synthetic_batch(pbundle, BATCH, seed=SEED)
    assert list(pl) == list(jl) == ["student", "teacher", "distill"]
    for task in jl:
        np.testing.assert_array_equal(pl[task].numpy(), jl[task], err_msg=task)
    assert not pl["distill"].any()
    assert set(pd) == set(jd) == {FLAG_SLOT}
    np.testing.assert_array_equal(pd[FLAG_SLOT].numpy(), jd[FLAG_SLOT])
    for key in jb:
        np.testing.assert_array_equal(pb[key].rows.numpy(), jb[key].rows, err_msg=key)
    np.testing.assert_array_equal(pw.numpy(), jw)


def test_default_factory_matches_the_jax_engine(monkeypatch):
    """At the JAX defaults: 49 mean columns of dim 16 in 25 storages (24 of
    51,296 rows, one of 25,648), the production registry's slots too; the
    factory and the server build on the card unless asked."""
    jbundle = jax_create_model("rough_rank")
    pbundle = create_model("rough_rank", device="cpu")
    assert pbundle.embedding.storage == jbundle.embedding.storage
    assert pbundle.embedding.table_map == jbundle.embedding.table_map
    assert sorted(pbundle.embedding.storage.values()).count((51296, 16)) == 24
    assert len(pbundle.embedding.storage) == 25
    assert pbundle.dense_input_keys == (FLAG_SLOT,)
    assert len(USER_FEATURE_IDS) == 33 and len(ITEM_FEATURE_IDS) == 19
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("rough_rank")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_server.main(["--model", "rough_rank"])


@pytest.mark.parametrize("stacked", [False, True])
def test_bridge_predict_and_flag_match_jax(stacked):
    jbundle, pbundle = _pair(stacked_experts=stacked)
    (jstate, jb, jd, *_), (pstate, pb, pd, *_) = _bridged(jbundle, pbundle, key=1)
    flat = bridge._flatten(jax.tree.map(np.asarray, jstate.params))
    assert set(flat) == set(pstate.params)
    if stacked:
        assert flat["sub_model_user.ple.specific_experts.kernel0"].shape == (8, 64, 32)
        assert flat["sub_model_item.ple.experts.kernel0"].shape == (4, 48, 32)
    else:
        assert flat["sub_model_user.ple.task1_expert3.kernel0"].shape == (64, 32)
    assert flat["teacher_cross.bias1"].shape == (112, 1)
    jpredict, ppredict = jax_make_predict_step(jbundle), make_predict_step(pbundle)
    outs = {}
    mixed = (np.arange(BATCH) % 3 == 0).astype(np.float32)[:, None]
    for name, flag in (("0", np.zeros((BATCH, 1), np.float32)),
                       ("1", np.ones((BATCH, 1), np.float32)), ("mixed", mixed)):
        want = jpredict(jstate, jb, {FLAG_SLOT: flag})
        got = ppredict(pstate, pb, {FLAG_SLOT: torch.from_numpy(flag)})
        assert set(got) == set(want) == set(SERVED)
        for task in SERVED:
            np.testing.assert_allclose(got[task].numpy(), np.asarray(want[task]), **TOL,
                                       err_msg=f"flag {name} {task}")
        outs[name] = {k: v.numpy() for k, v in got.items()}
    # the flag switches the user tower's branch per sample, not the item tower
    assert np.abs(outs["0"]["user_emb"] - outs["1"]["user_emb"]).min(axis=1).max() > 1e-6
    np.testing.assert_array_equal(outs["0"]["item_emb"], outs["1"]["item_emb"])
    sel = mixed[:, 0] == 1
    np.testing.assert_array_equal(outs["mixed"]["user_emb"][sel], outs["1"]["user_emb"][sel])
    np.testing.assert_array_equal(outs["mixed"]["user_emb"][~sel], outs["0"]["user_emb"][~sel])
    with pytest.raises(ValueError, match=FLAG_SLOT):
        ppredict(pstate, pb, None)


def test_service_with_the_dense_flag_matches_jax(pair):
    jbundle, pbundle = pair
    (jstate, *_), (pstate, *_) = _bridged(jbundle, pbundle, key=2)
    rng = np.random.default_rng(4)
    rows = [{s: [int(x) for x in rng.integers(0, 1 << 40, rng.integers(1, 6))]
             for s in USER + ITEM if rng.uniform() < 0.8} for _ in range(9)] + [{}]
    svc = ScoringService(pbundle, pstate, max_batch=16, device="cpu")
    jsvc = JaxScoringService(jbundle, jstate, max_batch=16)
    for dense in (None, [{FLAG_SLOT: 1.0}] * 10,
                  [{FLAG_SLOT: float(i % 2)} for i in range(10)]):
        want, got = jsvc.score(rows, dense), svc.score(rows, dense)
        assert set(got) == set(want) == set(SERVED)
        for task in SERVED:
            np.testing.assert_allclose(got[task], want[task], **TOL, err_msg=task)
        for task in ("student", "teacher"):
            assert 0.0 < min(got[task]) and max(got[task]) < 1.0
    # one row alone pads to bucket 8, in the batch to 16
    one = svc.score(rows[3:4], [{FLAG_SLOT: 1.0}])
    np.testing.assert_allclose(one["student"][0], got["student"][3], **TOL)


@pytest.mark.parametrize("ids_per_feature", [5, 1])
def test_three_steps_match_jax_packed_steps(pair, ids_per_feature):
    """Loss, the three task losses and ``regularization`` (0: rough_rank
    has no penalty) each step; then tables, moments, t and show, dense
    params and Adam's count."""
    jbundle, pbundle = pair
    jside, pside = _bridged(jbundle, pbundle, ids_per_feature=ids_per_feature)
    jstate, jb, jd, jl, jw = jside
    pstate, pb, pd, pl, pw = pside
    jstep = jax_make_train_step(jbundle, donate=False, sparse_update="packed")
    pstep = make_train_step(pbundle)
    reset_launch_counts()
    for i in range(3):
        jstate, jinfo = jstep(jstate, jb, jl, jw, jd, jax.random.PRNGKey(i))
        pstate, pinfo = pstep(pstate, pb, pl, pw, pd, seed=i)
        jinfo = jax.device_get(jinfo)
        assert set(pinfo) == set(jinfo) | {"regularization"}
        for name, want in jinfo.items():
            np.testing.assert_allclose(float(pinfo[name]), float(want), rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {name}")
        assert float(pinfo["regularization"]) == 0.0
    assert pstate.step == 3
    _assert_states_match(jbundle, jstate, pstate)
    assert set(launch_counts().values()) == {0}
