"""The train step's classic sparse updates against the JAX package's:
``sparse_update="scatter"`` and ``"dense"``, the packed step over storages
that cannot pack (an engine built with ``packed=False``, and a column of D
136), and the touched-rows update (``row_update_min_rows``).

Each comparison starts from one state, carried by ``bridge.from_jax_numpy``
(dense params, optax's Adam state, the tables' classic per-row view), and
takes 3 steps on one batch with attention dropout off on both sides, as
``tests/test_torch_autoint_train.py`` does.  Tolerances, as there: losses
rtol 1e-5; table weights and dense params atol 1e-5; Adam's moments and
AdaGrad's g2sum rtol 1e-4, atol 1e-9; t and show exact."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.embedding import EmbeddingFeatures as JaxEngine
from recommendsystem_tpu.embedding import SparseAdaGrad as JaxSparseAdaGrad
from recommendsystem_tpu.embedding import SparseAdam as JaxSparseAdam
from recommendsystem_tpu.embedding import category_column as jcat
from recommendsystem_tpu.embedding import embedding_column as jemb
from recommendsystem_tpu.embedding import packed as jpk
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.models.base import ModelBundle as JaxModelBundle
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train import losses as jax_losses
from recommendsystem_tpu.train.step import make_train_step as jax_make_train_step
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.embedding import (EmbeddingFeatures, SparseAdaGrad, SparseAdam,
                                                 category_column, embedding_column, packed)
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.base import ModelBundle
from recommendsystem_tpu_torch.nn import Dense
from recommendsystem_tpu_torch.train import create_train_state, make_scan_train_step
from recommendsystem_tpu_torch.train import losses as port_losses
from recommendsystem_tpu_torch.train import make_train_step
from recommendsystem_tpu_torch.train.adam import Adam
from test_torch_autoint_train import ATOL, LOSS_RTOL, MOMENT_TOL, NO_DROPOUT, _flat

torch.set_num_threads(1)
BATCH = 16


def _bridge(jbundle, jstate, pbundle):
    return bridge.from_jax_numpy(
        pbundle, jax.tree.map(np.asarray, jstate.params),
        jax.device_get(jbundle.embedding.classic_state(jstate.tables)),
        opt_state=jax.tree.map(np.asarray, jstate.opt_state))


def _assert_states_match(jbundle, jstate, pstate, what=""):
    jc = jax.device_get(jbundle.embedding.classic_state(jstate.tables))
    assert set(jc) == set(pstate.tables)
    for skey, want in jc.items():
        got = pstate.tables[skey]
        np.testing.assert_allclose(got["w"].float().numpy(), np.asarray(want["w"], np.float32),
                                   rtol=0, atol=ATOL, err_msg=f"{what} {skey}")
        assert set(got["opt"]) == set(want["opt"])
        for name, x in want["opt"].items():
            if name == "t":
                np.testing.assert_array_equal(got["opt"]["t"].numpy(), x, err_msg=skey)
            else:
                np.testing.assert_allclose(got["opt"][name].float().numpy(),
                                           np.asarray(x, np.float32), **MOMENT_TOL,
                                           err_msg=f"{what} {skey} {name}")
        np.testing.assert_array_equal(got["show"].numpy(), want["show"], err_msg=skey)
    jp = _flat(jax.device_get(jstate.params))
    assert set(jp) == set(pstate.params)
    for k, v in jp.items():
        np.testing.assert_allclose(pstate.params[k].numpy(), v, rtol=0, atol=ATOL,
                                   err_msg=f"{what} {k}")
    assert pstate.opt_state["count"] == int(jstate.opt_state[0].count)


def _run_both(jbundle, pbundle, sparse_update, jax_sparse_update=None, steps=3, seed=3,
              ids_per_feature=5):
    """``steps`` steps of each package's train step from one bridged state
    on one batch; returns (JAX state, port state), having held the losses
    step by step."""
    jb, jd, jl, jw = jax_synthetic_batch(jbundle, BATCH, seed=seed,
                                         ids_per_feature=ids_per_feature)
    pb, pd, pl, pw = synthetic_batch(pbundle, BATCH, seed=seed,
                                     ids_per_feature=ids_per_feature)
    jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(0), jb)
    pstate = _bridge(jbundle, jstate, pbundle)
    jstep = jax_make_train_step(jbundle, donate=False,
                                sparse_update=jax_sparse_update or sparse_update)
    pstep = make_train_step(pbundle, sparse_update=sparse_update)
    for i in range(steps):
        jstate, jinfo = jstep(jstate, jb, jl, jw, jd, jax.random.PRNGKey(i))
        pstate, pinfo = pstep(pstate, pb, pl, pw, pd, seed=i)
        np.testing.assert_allclose(float(pinfo["loss"]), float(jinfo["loss"]), rtol=LOSS_RTOL)
    assert pstate.step == steps
    return jstate, pstate


def _autoint(optimizer, bucket=256):
    """(JAX bundle, port bundle) of autoint without dropout, the tables
    under ``optimizer`` ("adam", the factory's, or "adagrad")."""
    jbundle = jax_create_model("autoint", bucket_size=bucket, model_param=NO_DROPOUT)
    pbundle = create_model("autoint", bucket_size=bucket, model_param=NO_DROPOUT, device="cpu")
    if optimizer == "adagrad":
        jeng, peng = jbundle.embedding, pbundle.embedding
        jbundle = dataclasses.replace(jbundle, embedding=JaxEngine(
            list(jeng.columns.values()), JaxSparseAdaGrad(learning_rate=0.05),
            group_tables=True, max_group_bytes=10 << 20))
        pbundle.embedding = EmbeddingFeatures(
            list(peng.columns.values()), SparseAdaGrad(learning_rate=0.05),
            group_tables=True, max_group_bytes=10 << 20)
    return jbundle, pbundle


@pytest.mark.parametrize("sparse_update,optimizer", [("scatter", "adam"), ("dense", "adam"),
                                                     ("scatter", "adagrad"),
                                                     ("dense", "adagrad")])
def test_classic_steps_match_jax(sparse_update, optimizer):
    """3 steps of ``sparse_update="scatter"`` or ``"dense"`` against the JAX
    package's, on autoint with its lazy Adam and with an AdaGrad engine.
    Nothing launches on the CPU; the classic sparse updates are plain
    PyTorch on any device."""
    jbundle, pbundle = _autoint(optimizer)
    reset_launch_counts()
    jstate, pstate = _run_both(jbundle, pbundle, sparse_update)
    assert set(launch_counts().values()) == {0}
    _assert_states_match(jbundle, jstate, pstate, sparse_update)


def test_scatter_and_dense_steps_agree():
    """The JAX package's own agreement of its two classic steps
    (``tests/test_embedding.py::test_train_step_modes_agree``), in the
    port: one step each from one state."""
    bundle = create_model("autoint", bucket_size=256, device="cpu")
    batch, dense, labels, w = synthetic_batch(bundle, 16, seed=0)
    s1, i1 = make_train_step(bundle, sparse_update="dense")(
        create_train_state(bundle, seed=0), batch, labels, w, None, seed=3)
    s2, i2 = make_train_step(bundle, sparse_update="scatter")(
        create_train_state(bundle, seed=0), batch, labels, w, None, seed=3)
    np.testing.assert_allclose(float(i2["loss"]), float(i1["loss"]), rtol=1e-6)
    for skey in s1.tables:
        np.testing.assert_allclose(s2.tables[skey]["w"].numpy(), s1.tables[skey]["w"].numpy(),
                                   rtol=1e-5, atol=1e-7)
    for k in s1.params:
        np.testing.assert_allclose(s2.params[k].numpy(), s1.params[k].numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_steps_update_the_state_in_place_and_refuse_unknown_updates():
    bundle = create_model("autoint", bucket_size=64, device="cpu")
    batch, dense, labels, w = synthetic_batch(bundle, 8, seed=1)
    for mode in ("scatter", "dense"):
        state = create_train_state(bundle, seed=0)
        ws = {k: t["w"] for k, t in state.tables.items()}
        before = {k: v.clone() for k, v in ws.items()}
        new, _ = make_train_step(bundle, sparse_update=mode)(state, batch, labels, w)
        assert all(new.tables[k]["w"] is ws[k] for k in ws)
        assert any(not torch.equal(ws[k], before[k]) for k in ws)
    with pytest.raises(ValueError, match="sparse_update 'sparse'"):
        make_train_step(bundle, sparse_update="sparse")
    # the scan driver passes the choice through
    s_a = create_train_state(bundle, seed=0)
    s_a, infos = make_scan_train_step(bundle, sparse_update="scatter")(
        s_a, [batch] * 2, [labels] * 2, [w] * 2, None, [0, 1])
    s_b = create_train_state(bundle, seed=0)
    step = make_train_step(bundle, sparse_update="scatter")
    for i in range(2):
        s_b, _ = step(s_b, batch, labels, w, seed=i)
    for k in s_a.tables:
        assert torch.equal(s_a.tables[k]["w"], s_b.tables[k]["w"])


# -- the packed step over storages that cannot pack ---------------------------

KEYS = ("a", "b", "c", "wide")
DIMS = {"a": 8, "b": 8, "c": 16, "wide": 136}
BUCKETS = {"a": 250, "b": 250, "c": 123, "wide": 70}


class _JaxTiny(fnn.Module):
    """Every column's embedding concatenated, one Dense to a sigmoid."""

    @fnn.compact
    def __call__(self, embs, training=False, dense_inputs=None):
        x = jnp.concatenate([embs[k] for k in KEYS], axis=1)
        return {"t": jax.nn.sigmoid(fnn.Dense(1, name="out")(x))}


class _PortTiny(torch.nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.out = Dense(sum(DIMS.values()), 1, device=device)

    def forward(self, embs, training=False, seed=0):
        x = torch.cat([embs[k] for k in KEYS], dim=1)
        return {"t": torch.sigmoid(self.out(x))}


def _tiny(packed_flag, group_bytes=1 << 15):
    """(JAX bundle, port bundle) of a tiny model over columns of D 8, 8, 16
    and 136 (the last cannot pack), its tables grouped as the engines
    group them, built with ``packed`` as given."""
    jcols = [jemb(jcat(k, BUCKETS[k]), DIMS[k], combiner="mean") for k in KEYS]
    pcols = [embedding_column(category_column(k, BUCKETS[k]), DIMS[k], combiner="mean")
             for k in KEYS]
    jeng = JaxEngine(jcols, JaxSparseAdam(learning_rate=1e-2), group_tables=True,
                     packed=packed_flag, max_group_bytes=group_bytes)
    peng = EmbeddingFeatures(pcols, SparseAdam(learning_rate=1e-2), group_tables=True,
                             packed=packed_flag, max_group_bytes=group_bytes)
    jbundle = JaxModelBundle(name="tiny", module=_JaxTiny(), embedding=jeng,
                             losses={"t": jax_losses.cross_entropy_sum_mean}, metrics={},
                             dense_optimizer=optax.adam(1e-3))
    pbundle = ModelBundle(name="tiny", module=_PortTiny(), embedding=peng, tasks=("t",),
                          device=torch.device("cpu"),
                          losses={"t": port_losses.cross_entropy_sum_mean},
                          dense_optimizer=Adam(1e-3))
    return jbundle, pbundle


@pytest.mark.parametrize("packed_flag", [True, False])
def test_packed_step_with_classic_storages_matches_jax(packed_flag):
    """The packed step over an engine whose D-136 storage cannot pack (and,
    built with ``packed=False``, whose other storages' offsets are left
    unaligned): the JAX packed step's in-step classic gather and scatter
    for those storages, the fold path for the rest; 3 steps against JAX's
    packed step."""
    jbundle, pbundle = _tiny(packed_flag)
    assert pbundle.embedding.storage == jbundle.embedding.storage
    pk, classic = packed.storages_packed(pbundle.embedding)
    assert (pk, classic) == jpk.storages_packed(jbundle.embedding)
    wide = pbundle.embedding.table_map["wide"][0]
    assert wide in classic
    if packed_flag:
        assert pk
    else:
        assert len(classic) > 1
    jstate, pstate = _run_both(jbundle, pbundle, "packed")
    _assert_states_match(jbundle, jstate, pstate, "packed")
    # the classic storages moved: their rows were trained in the step
    assert pstate.tables[wide]["show"].sum() > 0


def test_packed_step_equals_scatter_step_over_classic_storages():
    """Over an engine where no storage packs, the packed step is the
    scatter step: same losses, same state."""
    _, pbundle = _tiny(False, group_bytes=None)
    assert not packed.storages_packed(pbundle.embedding)[0]
    batch, dense, labels, w = synthetic_batch(pbundle, BATCH, seed=5)
    out = {}
    for mode in ("packed", "scatter"):
        state = create_train_state(pbundle, seed=1)
        step = make_train_step(pbundle, sparse_update=mode)
        losses = []
        for i in range(2):
            state, info = step(state, batch, labels, w, dense, seed=i)
            losses.append(float(info["loss"]))
        out[mode] = (state, losses)
    np.testing.assert_allclose(out["packed"][1], out["scatter"][1], rtol=1e-6)
    for skey in out["packed"][0].tables:
        np.testing.assert_allclose(out["packed"][0].tables[skey]["w"].numpy(),
                                   out["scatter"][0].tables[skey]["w"].numpy(), rtol=0, atol=1e-6)


# -- the touched-rows update -------------------------------------------------

def test_touched_rows_update_matches_jax_and_the_lazy_pass():
    """``row_update_min_rows = 0``: every ``state_packable`` storage takes
    the touched-rows update (sort, segment sum, the unique rows only).  3
    steps against the JAX package's row mode, and the port's two modes
    against each other (the JAX package's own test of its two modes,
    ``tests/test_packed_state.py``): losses rtol 1e-6, tables rtol 1e-6,
    atol 1e-7."""
    jbundle, pbundle = _autoint("adam", bucket=300)
    eng = pbundle.embedding
    assert all(packed.state_packable(eng, s) for s in eng.storage)
    jbundle.embedding.row_update_min_rows = 0
    eng.row_update_min_rows = 0
    reset_launch_counts()
    jstate, rows_state = _run_both(jbundle, pbundle, "packed")
    assert set(launch_counts().values()) == {0}
    _assert_states_match(jbundle, jstate, rows_state, "rows")
    # the port's lazy pass from the same state and batch
    eng.row_update_min_rows = 1 << 62
    _, lazy_state = _run_both(jbundle, pbundle, "packed")
    for skey, t in lazy_state.tables.items():
        r = rows_state.tables[skey]
        for name, got, want in [("w", r["w"], t["w"]), ("show", r["show"], t["show"])] + [
                (n, r["opt"][n], t["opt"][n]) for n in t["opt"]]:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{skey} {name}")


def test_touched_rows_update_leaves_untouched_rows_bit_identical():
    """The JAX package's test of the same guarantee
    (``tests/test_packed_state.py``): only rows the batch touched change."""
    bundle = create_model("autoint", bucket_size=1024, device="cpu")
    bundle.embedding.row_update_min_rows = 0
    batch, dense, labels, weight = synthetic_batch(bundle, 8, seed=1)
    state = create_train_state(bundle, seed=0)
    before = {k: {"w": t["w"].clone(), "show": t["show"].clone(),
                  **{n: x.clone() for n, x in t["opt"].items()}}
              for k, t in state.tables.items()}
    state, _ = make_train_step(bundle)(state, batch, labels, weight, dense, seed=2)
    eng = bundle.embedding
    touched = {skey: set() for skey in state.tables}
    for key, col in eng.columns.items():
        skey, off, _ = eng.table_map[col.categorical_column.key]
        live = batch[key].mask > 0
        touched[skey].update((batch[key].rows[live] + off).tolist())
    for skey, t in state.tables.items():
        after = {"w": t["w"], "show": t["show"], **t["opt"]}
        changed = set()
        for name, x in after.items():
            diff = (x != before[skey][name]).reshape(x.shape[0], -1).any(dim=1)
            changed |= set(diff.nonzero().flatten().tolist())
        assert changed == touched[skey], skey
        # nothing left in the accumulator: the row mode does not use it
        assert not eng.accumulator(skey, "cpu").any()


def test_row_update_packed_storage_sums_duplicate_rows():
    """One storage's touched-rows update: a row that appears three times
    steps once with its gradients summed and a count of 3; masked entries
    count nothing; the rest stays as it was."""
    opt = SparseAdam(learning_rate=0.1)
    eng = EmbeddingFeatures([embedding_column(category_column("x", 28), 8)], opt)
    state = eng.init(torch.Generator().manual_seed(0))["x"]
    before = {n: x.clone() for n, x in [("w", state["w"]), ("show", state["show"]),
                                        *state["opt"].items()]}
    ids = torch.tensor([5, 2, 5, 5, 9], dtype=torch.int32)
    g = torch.arange(40, dtype=torch.float32).reshape(5, 8) / 100
    live = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0])
    pay = torch.cat([g * live[:, None], live[:, None]], dim=1)
    packed.row_update_packed_storage(opt, state, ids, pay)
    want_w, want = opt.update_rows(before["w"][[2, 5]], torch.stack([g[1], g[0] + g[2] + g[3]]),
                                   {n: before[n][[2, 5]] for n in ("m", "v", "t")},
                                   torch.ones((2, 1)))
    torch.testing.assert_close(state["w"][[2, 5]], want_w, rtol=0, atol=1e-7)
    assert state["show"][[2, 5]].flatten().tolist() == [1.0, 3.0]
    assert state["opt"]["t"][[2, 5]].flatten().tolist() == [1.0, 1.0]
    others = [r for r in range(state["w"].shape[0]) if r not in (2, 5)]
    for name, x in [("w", state["w"]), ("show", state["show"]), *state["opt"].items()]:
        assert torch.equal(x[others], before[name][others]), name
    with pytest.raises(ValueError, match="payload"):
        packed.row_update_packed_storage(opt, state, ids, pay[:, :8])
