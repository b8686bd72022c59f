"""The port's staytime scoring path as a whole against the JAX package:
synthetic batches, the fused lookup with sequence columns in mixed
storages, the predict step and the full outputs, and the scoring service,
with weights and AdaGrad state carried by ``bridge.from_jax_numpy``.

Configurations: the 91-slot ``StaytimeConfig(bucket_size=128,
seq_max_len=4)`` with experts of (16, 8), and the 16-slot config of
``tests/test_tf_parity_staytime.py``, also with its tables split into
storages of three, so that mean and sequence columns share storages in
several ways.  Tolerances rtol 1e-5, atol 2e-6 (float32 products summed in
another order by XLA-CPU and torch), and rtol 1e-5 for the expected value
(a sum of 400 products)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.data.staytime_labels import staytime_labels as jax_staytime_labels
from recommendsystem_tpu.embedding import EmbeddingFeatures as JaxEmbeddingFeatures
from recommendsystem_tpu.embedding import packed as jax_packed
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.models.staytime import StaytimeConfig as JaxStaytimeConfig
from recommendsystem_tpu.serving import ScoringService as JaxScoringService
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train.step import apply_model as jax_apply_model
from recommendsystem_tpu.train.step import make_predict_step as jax_make_predict_step
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.data.staytime_labels import staytime_labels
from recommendsystem_tpu_torch.embedding import EmbeddingFeatures
from recommendsystem_tpu_torch.embedding import packed
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.staytime import (T_LONG, T_SHORT, T_STAY,
                                                       StaytimeConfig)
from recommendsystem_tpu_torch.serving import ScoringService
from recommendsystem_tpu_torch.serving import server as port_server
from recommendsystem_tpu_torch.train import apply_model, make_predict_step, make_train_step

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)
EV_TOL = dict(rtol=1e-5)
HIDDEN = (16, 8)

SMALL = dict(bucket_size=128, seq_max_len=4)
SLOTS16 = tuple(str(9000 + i) for i in range(16))
CFG16 = dict(
    slots=SLOTS16,
    seq_slots=(SLOTS16[8], SLOTS16[9], SLOTS16[10]),
    user_slots=SLOTS16[0:4],
    item_slots=SLOTS16[4:8],
    bias_slots=(SLOTS16[0], SLOTS16[2], SLOTS16[4], SLOTS16[6], SLOTS16[11], SLOTS16[12]),
    seq_query=((SLOTS16[8], SLOTS16[4]), (SLOTS16[9], SLOTS16[5]),
               (SLOTS16[10], SLOTS16[6])),
    seq_max_len=5,
    bucket_size=64,
)
# three 72 x 32 tables per storage: 6 storages, the 3 sequence columns in 2
GROUP3 = 3 * 72 * 32 * 4
CONFIGS = {"small": (SMALL, None), "cfg16": (CFG16, None), "cfg16_split": (CFG16, GROUP3)}


def _bundles(name):
    kw, group_bytes = CONFIGS[name]
    jbundle = jax_create_model("staytime", cfg=JaxStaytimeConfig(**kw),
                               deep_hidden_units=HIDDEN)
    pbundle = create_model("staytime", cfg=StaytimeConfig(**kw),
                           deep_hidden_units=HIDDEN, device="cpu")
    if group_bytes is not None:
        jeng, peng = jbundle.embedding, pbundle.embedding
        jbundle = dataclasses.replace(jbundle, embedding=JaxEmbeddingFeatures(
            list(jeng.columns.values()), jeng.sparse_opt, group_tables=True,
            max_group_bytes=group_bytes))
        pbundle.embedding = EmbeddingFeatures(
            list(peng.columns.values()), peng.sparse_opt, group_tables=True,
            max_group_bytes=group_bytes)
    return jbundle, pbundle


_PAIRS = {}


def _pair(name):
    """(JAX bundle, JAX state, port bundle, port state); the port's tables
    carry the JAX AdaGrad state (w, g2sum, show) through ``classic_state``."""
    if name not in _PAIRS:
        jbundle, pbundle = _bundles(name)
        jbatch, _, _, _ = jax_synthetic_batch(jbundle, 8, seed=0)
        jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(1), jbatch)
        classic = jbundle.embedding.classic_state(jstate.tables)
        pstate = bridge.from_jax_numpy(
            pbundle, jax.tree.map(np.asarray, jstate.params),
            jax.tree.map(np.asarray, classic))
        _PAIRS[name] = (jbundle, jstate, pbundle, pstate)
    return _PAIRS[name]


def _same_batches(jbundle, pbundle, b, seed, ids_per_feature):
    jout = jax_synthetic_batch(jbundle, b, seed=seed, ids_per_feature=ids_per_feature)
    pout = synthetic_batch(pbundle, b, seed=seed, ids_per_feature=ids_per_feature)
    return jout, pout


@pytest.mark.parametrize("ids_per_feature", [5, 1, {"1568": 3, "2125": 2}])
def test_synthetic_batch_matches_jax_to_the_byte(ids_per_feature):
    jbundle, pbundle = _bundles("small")
    (jb, _, jl, jw), (pb, _, pl, pw) = _same_batches(jbundle, pbundle, 24, 5,
                                                     ids_per_feature)
    assert set(pb) == set(jb) and len(pb) == 94
    for k in jb:
        for a, w in ((pb[k].rows.numpy(), jb[k].rows), (pb[k].mask.numpy(), jb[k].mask)):
            assert a.dtype == w.dtype and a.tobytes() == w.tobytes(), k
    assert set(pl) == set(jl) == {T_STAY, T_SHORT, T_LONG}
    for k in jl:
        assert pl[k].numpy().dtype == jl[k].dtype and pl[k].numpy().tobytes() == jl[k].tobytes()
    assert pl[T_STAY].shape == (24, 401)
    assert pw.numpy().dtype == jw.dtype and pw.numpy().tobytes() == jw.tobytes()


def test_staytime_labels_match_jax_to_the_byte():
    wt = np.array([0, 6999, 7001, 18001, 250_000, 42_000], np.int64)
    extra = np.array(["a", "x_video_homepage_landing_y", "", "b", "c", "video_homepage_landing"])
    for args in ((wt,), (wt, extra)):
        (got, gw), (want, ww) = staytime_labels(*args), jax_staytime_labels(*args)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k
        assert gw.tobytes() == ww.tobytes()


@pytest.mark.parametrize("name", ["cfg16", "cfg16_split"])
def test_lookup_packed_with_sequence_columns_matches_jax_and_oracle(name):
    jbundle, jstate, pbundle, pstate = _pair(name)
    peng = pbundle.embedding
    (jb, _, _, _), (pb, _, _, _) = _same_batches(jbundle, pbundle, 12, 3, 2)
    plans = packed.plan_segments(peng, pb)
    mixed = [s for s, segs in plans.items() if {g.kind for g in segs} == {"mean", "seq"}]
    assert mixed and sum(g.kind == "seq" for segs in plans.values() for g in segs) == 3
    if name == "cfg16_split":
        assert len(peng.storage) == 6 and len(mixed) == 2   # one holds two
    got = packed.lookup_packed(peng, pstate.tables, pb)
    want = jax_packed.lookup_packed(jbundle.embedding, jstate.tables, jb)
    oracle = peng.lookup(peng.weights(pstate.tables), pb)
    assert set(got) == set(want) == set(oracle)
    for k, v in got.items():
        if isinstance(v, tuple):
            emb, mask = v
            assert emb.shape == (12, CFG16["seq_max_len"], 32)
            np.testing.assert_allclose(emb.numpy(), np.asarray(want[k][0]), **TOL)
            np.testing.assert_array_equal(mask.numpy(), np.asarray(want[k][1]))
            torch.testing.assert_close(emb, oracle[k][0], rtol=0, atol=0)
            assert torch.equal(mask, oracle[k][1])
        else:
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), **TOL)
            torch.testing.assert_close(v, oracle[k], rtol=1e-6, atol=1e-7)


def _compare_predictions(got, want, n):
    assert set(got) == set(want) == {T_STAY, T_SHORT, T_LONG}
    for k in got:
        assert got[k].shape == (n, 1)
        tol = EV_TOL if k == T_STAY else TOL
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **tol)


@pytest.mark.parametrize("name,ids_per_feature", [("small", 5), ("small", 1),
                                                  ("cfg16", 5), ("cfg16_split", 3)])
def test_predict_step_matches_jax(name, ids_per_feature):
    jbundle, jstate, pbundle, pstate = _pair(name)
    (jb, _, _, _), (pb, _, _, _) = _same_batches(jbundle, pbundle, 32, 11,
                                                 ids_per_feature)
    want = jax_make_predict_step(jbundle)(jstate, jb, None)
    got = make_predict_step(pbundle)(pstate, pb)
    _compare_predictions(got, want, 32)
    ev = got[T_STAY].numpy()
    assert np.all(np.isfinite(ev)) and ev.min() >= 0.0 and ev.max() <= 180.5
    for k in (T_SHORT, T_LONG):
        assert 0.0 < got[k].min() and got[k].max() < 1.0


@pytest.mark.parametrize("name", ["small", "cfg16_split"])
def test_full_outputs_match_jax(name):
    """Every output of the module, the 401-wide staytime train head among
    them, from the same lookups."""
    jbundle, jstate, pbundle, pstate = _pair(name)
    (jb, _, _, _), (pb, _, _, _) = _same_batches(jbundle, pbundle, 16, 21, 5)
    jembs = jax_packed.lookup_packed(jbundle.embedding, jstate.tables, jb)
    want = jax.jit(lambda p, e: jax_apply_model(jbundle, p, e))(jstate.params, jembs)
    with torch.no_grad():
        got = apply_model(pbundle, pstate.params,
                          packed.lookup_packed(pbundle.embedding, pstate.tables, pb))
    assert set(got) == set(want)
    assert got[T_STAY].shape == (16, 401)
    for k in got:
        tol = EV_TOL if k.startswith(T_STAY) else TOL
        if k == T_STAY:       # the distribution, then its expected value
            np.testing.assert_allclose(got[k][:, :400].numpy(), np.asarray(want[k])[:, :400],
                                       err_msg=k, **TOL)
            np.testing.assert_allclose(got[k][:, 400:].numpy(), np.asarray(want[k])[:, 400:],
                                       err_msg=k, **EV_TOL)
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **tol)
    np.testing.assert_allclose(got[T_STAY][:, :400].sum(1).numpy(), 1.0, rtol=1e-5)


def _raw_rows(rng, n, cfg, with_seq):
    rows = []
    for i in range(n):
        row = {}
        for s in cfg["slots"] if "slots" in cfg else StaytimeConfig().slots:
            if rng.uniform() < 0.8:
                row[s] = [int(x) for x in rng.integers(0, 1 << 40, rng.integers(1, 6))]
        if not with_seq[i]:
            for s in cfg.get("seq_slots", StaytimeConfig().seq_slots):
                row.pop(s, None)
        rows.append(row)
    return rows


@pytest.fixture(scope="module")
def services():
    jbundle, jstate, pbundle, pstate = _pair("cfg16_split")
    return (JaxScoringService(jbundle, jstate, max_batch=16),
            ScoringService(pbundle, pstate, max_batch=16, device="cpu"))


def test_score_matches_jax_service(services):
    """Raw rows through both services, among them rows with no sequence
    feature (an all-0 mask for every DIN pool) and an empty row."""
    jsvc, psvc = services
    rng = np.random.default_rng(4)
    rows = _raw_rows(rng, 6, CFG16, with_seq=[True, False, True, False, True, True]) + [{}]
    want = jsvc.score(rows)
    got = psvc.score(rows)
    assert set(got) == set(want) == {T_STAY, T_SHORT, T_LONG}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **(EV_TOL if k == T_STAY else TOL))
    assert all(0.0 <= v <= 180.5 for v in got[T_STAY])
    assert all(0.0 < v < 1.0 for k in (T_SHORT, T_LONG) for v in got[k])


def test_padding_does_not_change_a_row(services):
    _, psvc = services
    rows = _raw_rows(np.random.default_rng(5), 11, CFG16, with_seq=[i % 3 > 0 for i in range(11)])
    full = psvc.score(rows)                 # bucket 16
    for i in (0, 3):
        alone = psvc.score([rows[i]])       # bucket 8
        for k in full:
            np.testing.assert_allclose(alone[k][0], full[k][i], **TOL)


def test_sequence_slot_width_is_ids_per_feature(services):
    """The mean and sequence columns of a slot read one request feature, as
    in the JAX package: a sequence slot carries at most ids_per_feature."""
    jsvc, psvc = services
    seq_slot = CFG16["seq_slots"][0]
    with pytest.raises(ValueError, match="compiled width is 5"):
        psvc.score([{seq_slot: list(range(6))}])
    with pytest.raises(ValueError, match="compiled width is 5"):
        jsvc.score([{seq_slot: list(range(6))}])


def test_full_width_storages_and_launch_plan_match_jax():
    """91 tables of 81,924 x 32 in 46 storages of at most 30 MB (45 pairs
    and one single), as the JAX engine groups them; a predict call then
    folds 46 mean segments (K1 with 5 ids, K2 with 1) and 3 sequence
    segments (K2)."""
    peng = create_model("staytime", device="cpu").embedding
    jeng = jax_create_model("staytime").embedding
    assert peng.storage == jeng.storage and peng.table_map == jeng.table_map
    assert len(peng.storage) == 46
    assert sorted(r for r, _ in peng.storage.values()) == [81924] + [2 * 81924] * 45
    assert {d for _, d in peng.storage.values()} == {32}
    pbundle = create_model("staytime", device="cpu")
    for ipf, mean_l in ((5, 5), (1, 1)):
        batch = synthetic_batch(pbundle, 2, seed=1, ids_per_feature=ipf)[0]
        segs = [g for s in packed.plan_segments(peng, batch).values() for g in s]
        assert sum(g.kind == "mean" and g.l == mean_l for g in segs) == 46
        assert sum(g.kind == "seq" and g.l == 50 for g in segs) == 3
        assert len(segs) == 49


def test_bridge_carries_adagrad_state_and_weights():
    jbundle, jstate, pbundle, pstate = _pair("cfg16_split")
    classic = jbundle.embedding.classic_state(jstate.tables)
    for skey, t in pstate.tables.items():
        assert set(t["opt"]) == {"g2sum"}
        np.testing.assert_array_equal(t["opt"]["g2sum"].numpy(),
                                      np.asarray(classic[skey]["opt"]["g2sum"]))
        np.testing.assert_array_equal(t["w"].numpy(), np.asarray(classic[skey]["w"]))
    weights_only = bridge.from_jax_numpy(
        pbundle, jax.tree.map(np.asarray, jstate.params),
        {k: np.asarray(v) for k, v in jbundle.embedding.weights(jstate.tables).items()})
    for t in weights_only.tables.values():
        assert torch.equal(t["opt"]["g2sum"], torch.full_like(t["opt"]["g2sum"], 0.1))
        assert not t["show"].any()
    bad = jax.tree.map(np.asarray, classic)
    skey = sorted(bad)[0]
    bad[skey]["opt"] = {"m": bad[skey]["opt"]["g2sum"]}
    with pytest.raises(ValueError, match="optimizer state"):
        bridge.from_jax_numpy(pbundle, jax.tree.map(np.asarray, jstate.params), bad)


def test_seeded_init_draws_adagrad_tables():
    pbundle = create_model("staytime", cfg=StaytimeConfig(**SMALL),
                           deep_hidden_units=HIDDEN, device="cpu")
    from recommendsystem_tpu_torch.train import create_train_state
    a, b = create_train_state(pbundle, 3), create_train_state(pbundle, 3)
    (skey,) = a.tables
    t = a.tables[skey]
    assert torch.equal(t["w"], b.tables[skey]["w"])
    assert t["w"].shape == (91 * 132, 32)
    assert float(t["w"].abs().max()) <= 0.1 and float(t["w"].std()) > 0.05
    assert torch.equal(t["opt"]["g2sum"], torch.full((91 * 132, 1), 0.1))
    assert not t["show"].any()


def test_train_step_takes_adagrad_and_refuses_an_optimizer_without_a_pass():
    """The staytime engine's AdaGrad trains on the packed step (its lazy
    pass is K9); an optimizer with no pass on the packed update raises."""
    _, pbundle = _bundles("cfg16")
    from recommendsystem_tpu_torch.train import create_train_state
    state = create_train_state(pbundle, seed=0)
    pb, pd, pl, pw = synthetic_batch(pbundle, 8, seed=1)
    before = {k: t["opt"]["g2sum"].clone() for k, t in state.tables.items()}
    state, info = make_train_step(pbundle)(state, pb, pl, pw, pd, seed=0)
    assert np.isfinite(float(info["loss"])) and state.step == 1
    assert any((t["opt"]["g2sum"] > before[k]).any() for k, t in state.tables.items())

    @dataclasses.dataclass(frozen=True)
    class SparseSGD:
        learning_rate: float = 0.1

    pbundle.embedding.sparse_opt = SparseSGD()
    with pytest.raises(NotImplementedError, match="SparseSGD"):
        make_train_step(pbundle)


def test_stacked_experts_match_jax():
    """``stacked_experts=True`` builds the three gated experts as one stack ``experts`` (kernels (3, in, out))
    and its predict step matches the JAX stacked model's."""
    kw = dict(cfg=JaxStaytimeConfig(**SMALL), deep_hidden_units=HIDDEN, stacked_experts=True)
    jbundle = jax_create_model("staytime", **kw)
    pbundle = create_model("staytime", cfg=StaytimeConfig(**SMALL), deep_hidden_units=HIDDEN,
                           stacked_experts=True, device="cpu")
    jbatch, _, _, _ = jax_synthetic_batch(jbundle, 8, seed=0)
    jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(2), jbatch)
    pstate = bridge.from_jax_numpy(
        pbundle, jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jbundle.embedding.classic_state(jstate.tables)))
    assert pstate.params["experts.gate_1_2.kernel"].shape == (3, 8, 8)
    (jb, _, _, _), (pb, _, _, _) = _same_batches(jbundle, pbundle, 32, 12, 5)
    want = jax_make_predict_step(jbundle)(jstate, jb, None)
    _compare_predictions(make_predict_step(pbundle)(pstate, pb), want, 32)


def test_server_takes_staytime_without_bucket_size(monkeypatch):
    with pytest.raises(SystemExit):
        port_server.main(["--model", "staytime", "--bucket-size", "256"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_server.main(["--model", "staytime"])
