"""Port parity for the lazy per-row AdaGrad and the admission hook:
``SparseAdaGrad`` (the port's plain optimizer), K9
``sparse_adagrad_update`` (its CPU path, the kernel's plain version), stage
3 of the packed update on an AdaGrad engine, and ``evict`` /
``maybe_evict``, against the JAX package's ``SparseAdaGrad``, the
classic-state branch of its ``apply_gradients_packed`` and its ``evict``.

Tolerances: w atol 1e-7 and g2sum rtol 1e-6 for the optimizer alone (the
same float32 arithmetic; the mean of the squares may sum in another order);
stage 3 as the train-step tests (w atol 1e-5, g2sum rtol 1e-4 / atol 1e-9);
rows whose count is 0 bit-identical; show exact (sums of integer counts).
``evict`` draws its fresh rows from a ``torch.Generator`` where the JAX
engine draws from a PRNG key, so the fresh weights are held to their range
and the rest of the state exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.embedding import EmbeddingFeatures as JaxEngine
from recommendsystem_tpu.embedding import SparseAdaGrad as JaxSparseAdaGrad
from recommendsystem_tpu.embedding import category_column as jcat
from recommendsystem_tpu.embedding import embedding_column as jemb
from recommendsystem_tpu.embedding import packed as jpk
from recommendsystem_tpu_torch.embedding import (EmbeddingFeatures, IdBatch, category_column,
                                                 embedding_column, packed)
from recommendsystem_tpu_torch.embedding.optimizers import SparseAdaGrad, SparseAdam
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.kernels._build import KERNELS

torch.set_num_threads(1)
W_ATOL = 1e-7
G2_RTOL = 1e-6
STEP_ATOL = 1e-5
STEP_G2 = dict(rtol=1e-4, atol=1e-9)


def _state(rng, rows, d):
    return {"w": rng.uniform(-0.1, 0.1, (rows, d)).astype(np.float32),
            "opt": {"g2sum": rng.uniform(0.1, 0.5, (rows, 1)).astype(np.float32)},
            "show": rng.integers(0, 9, (rows, 1)).astype(np.float32)}


def _acc(rng, rows, d, live=0.4):
    """(rows, D+1) [grad | count]: a share ``live`` of rows with counts 1..4
    and gradients, the others all zero, as the unfold-scatter leaves it."""
    cnt = np.where(rng.uniform(size=(rows, 1)) < live,
                   rng.integers(1, 5, (rows, 1)), 0).astype(np.float32)
    g = rng.standard_normal((rows, d)).astype(np.float32) * 1e-2 * (cnt > 0)
    return np.concatenate([g, cnt], axis=1)


def _flat(acc):
    """The port's flat accumulator: the (rows, D) gradient block, then the
    (rows,) counts."""
    return torch.tensor(np.concatenate([acc[:, :-1].ravel(), acc[:, -1]]))


def _torch(state):
    return {"w": torch.tensor(state["w"]),
            "opt": {n: torch.tensor(x) for n, x in state["opt"].items()},
            "show": torch.tensor(state["show"])}


def _assert_state(got, want, before, cnt, w_atol=W_ATOL, g2=None):
    np.testing.assert_allclose(got["w"], want["w"], rtol=0, atol=w_atol)
    np.testing.assert_allclose(got["opt"]["g2sum"], want["opt"]["g2sum"],
                               **(g2 or dict(rtol=G2_RTOL, atol=0)))
    np.testing.assert_array_equal(got["show"], want["show"])
    dead = cnt[:, 0] == 0
    np.testing.assert_array_equal(got["w"][dead], before["w"][dead])
    np.testing.assert_array_equal(got["opt"]["g2sum"][dead], before["opt"]["g2sum"][dead])
    np.testing.assert_array_equal(got["show"][dead], before["show"][dead])


def _np(state):
    return {"w": np.asarray(state["w"]),
            "opt": {n: np.asarray(x) for n, x in state["opt"].items()},
            "show": np.asarray(state["show"])}


@pytest.mark.parametrize("lr", [5e-3, 1e-1])
def test_sparse_adagrad_update_matches_jax(lr):
    rng = np.random.default_rng(int(lr * 1e3))
    before, acc = _state(rng, 96, 32), _acc(rng, 96, 32)
    g, cnt = acc[:, :32], acc[:, 32:]
    row_mask = (cnt > 0).astype(np.float32)
    jw, jopt = JaxSparseAdaGrad(learning_rate=lr).update(
        jnp.asarray(before["w"]), jnp.asarray(g), {"g2sum": jnp.asarray(before["opt"]["g2sum"])},
        jnp.asarray(row_mask))
    pw, popt = SparseAdaGrad(learning_rate=lr).update(
        torch.tensor(before["w"]), torch.tensor(g),
        {"g2sum": torch.tensor(before["opt"]["g2sum"])}, torch.tensor(row_mask))
    show = before["show"] + cnt
    _assert_state({"w": pw.numpy(), "opt": {"g2sum": popt["g2sum"].numpy()}, "show": show},
                  {"w": np.asarray(jw), "opt": {"g2sum": np.asarray(jopt["g2sum"])},
                   "show": show}, before, cnt)


def test_update_rows_matches_jax():
    rng = np.random.default_rng(3)
    before = _state(rng, 32, 16)
    g = rng.standard_normal((32, 16)).astype(np.float32) * 1e-2
    valid = (rng.uniform(size=(32, 1)) < 0.7).astype(np.float32)
    jw, jopt = JaxSparseAdaGrad().update_rows(
        jnp.asarray(before["w"]), jnp.asarray(g),
        {"g2sum": jnp.asarray(before["opt"]["g2sum"])}, jnp.asarray(valid))
    pw, popt = SparseAdaGrad().update_rows(
        torch.tensor(before["w"]), torch.tensor(g),
        {"g2sum": torch.tensor(before["opt"]["g2sum"])}, torch.tensor(valid))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=0, atol=W_ATOL)
    np.testing.assert_allclose(popt["g2sum"].numpy(), np.asarray(jopt["g2sum"]),
                               rtol=G2_RTOL, atol=0)
    dead = valid[:, 0] == 0
    np.testing.assert_array_equal(pw.numpy()[dead], before["w"][dead])
    assert SparseAdaGrad().feature_drop_show == JaxSparseAdaGrad().feature_drop_show == -1.0


@pytest.mark.parametrize("d,live", [(8, 0.4), (32, 0.0), (32, 1.0), (48, 0.4)])
def test_k9_plain_matches_the_jax_classic_branch(d, live):
    """K9's CPU path against what the JAX ``apply_gradients_packed`` does
    for a classic-state storage (``packed.py:714-731``): ``SparseAdaGrad.update``
    on the accumulator's G and counts, then show plus the counts."""
    rng = np.random.default_rng(d + int(live * 10))
    rows = 120
    before, acc = _state(rng, rows, d), _acc(rng, rows, d, live)
    g, cnt = acc[:, :d], acc[:, d:]
    jw, jopt = JaxSparseAdaGrad().update(
        jnp.asarray(before["w"]), jnp.asarray(g), {"g2sum": jnp.asarray(before["opt"]["g2sum"])},
        jnp.asarray((cnt > 0).astype(np.float32)))
    want = {"w": np.asarray(jw), "opt": {"g2sum": np.asarray(jopt["g2sum"])},
            "show": before["show"] + cnt}
    tstate, tacc = _torch(before), _flat(acc)
    reset_launch_counts()
    assert packed.sparse_adagrad_update(SparseAdaGrad(), tstate, tacc) is None   # in place
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    _assert_state(_np(tstate), want, before, cnt)
    assert not tacc.any()                       # the accumulator is left zero


def test_k9_group_equals_its_members_and_its_oracle():
    """The grouped wrapper over storages of D 8, 16, 32 and 48 (one empty,
    one with no live row) equals ``sparse_adagrad_update_plain`` member by
    member, bit for bit, and leaves every accumulator zero."""
    rng = np.random.default_rng(5)
    shapes = ((64, 8, 0.5), (40, 16, 0.3), (0, 32, 0.5), (72, 32, 0.0), (24, 48, 0.9))
    befores = [_state(rng, r, d) for r, d, _ in shapes]
    accs = [_acc(rng, r, d, live) for r, d, live in shapes]
    got = [_torch(b) for b in befores]
    got_accs = [_flat(a) for a in accs]
    packed.sparse_adagrad_update_group(SparseAdaGrad(), got, got_accs)
    for b, a, g, ga in zip(befores, accs, got, got_accs):
        want, want_acc = _torch(b), _flat(a)
        packed.sparse_adagrad_update_plain(SparseAdaGrad(), want, want_acc)
        for x, y in ((g["w"], want["w"]), (g["opt"]["g2sum"], want["opt"]["g2sum"]),
                     (g["show"], want["show"])):
            assert torch.equal(x, y)
        assert not ga.any()
    with pytest.raises(ValueError, match="accumulators"):
        packed.sparse_adagrad_update_group(SparseAdaGrad(), got, got_accs[:2])
    bad = _torch(befores[0])
    bad["opt"]["g2sum"] = bad["opt"]["g2sum"][:-1]
    with pytest.raises(ValueError, match="g2sum"):
        packed.sparse_adagrad_update_group(SparseAdaGrad(), [bad], [_flat(accs[0])])


def test_sparse_update_group_picks_the_optimizers_pass(monkeypatch):
    calls = []
    monkeypatch.setattr(packed, "sparse_adam_update_group", lambda *a: calls.append("K8"))
    monkeypatch.setattr(packed, "sparse_adagrad_update_group", lambda *a: calls.append("K9"))
    packed.sparse_update_group(SparseAdam(), [], [])
    packed.sparse_update_group(SparseAdaGrad(), [], [])
    assert calls == ["K8", "K9"]

    @dataclasses.dataclass(frozen=True)
    class SparseSGD:
        learning_rate: float = 0.1

    with pytest.raises(NotImplementedError, match="SparseSGD"):
        packed.sparse_update_group(SparseSGD(), [], [])


def _engines(group_bytes):
    """Staytime-like columns: 6 mean slots of dim 32 over 64-id buckets, two
    of them also sequence columns of 4 that share their tables."""
    slots = [str(9000 + i) for i in range(6)]
    seq = slots[:2]

    def cols(cat, emb):
        out = []
        for s in slots:
            c = cat(s, 64)
            out.append(emb(c, 32, combiner="mean"))
            if s in seq:
                out.append(emb(c, 32, combiner=None, seq_max_len=4, name=f"seq_{s}"))
        return out

    jeng = JaxEngine(cols(jcat, jemb), JaxSparseAdaGrad(), group_tables=True,
                     max_group_bytes=group_bytes)
    peng = EmbeddingFeatures(cols(category_column, embedding_column), SparseAdaGrad(),
                             group_tables=True, max_group_bytes=group_bytes)
    assert peng.storage == jeng.storage and peng.table_map == jeng.table_map
    return jeng, peng


def _batch(peng, b, ids_per_feature, rng):
    batch = {}
    for key, col in peng.columns.items():
        l = col.seq_max_len if col.is_sequence else ids_per_feature
        rows = rng.integers(0, 64, (b, l)).astype(np.int32)
        mask = (rng.uniform(size=(b, l)) < 0.8).astype(np.float32)
        batch[key] = (rows * (mask > 0), mask)
    return batch


@pytest.mark.parametrize("ids_per_feature", [5, 1])
@pytest.mark.parametrize("group_bytes", [3 * 64 * 32 * 4, 1])
def test_apply_gradients_packed_on_adagrad_matches_jax(group_bytes, ids_per_feature):
    """Stage 3 alone on random activation grads, mean and sequence columns
    sharing storages (three tables a storage) or each table its own: the
    port's one grouped K3, K4 and K9 against the JAX package's per-column
    unfolds and its classic-state AdaGrad branch."""
    from recommendsystem_tpu.embedding.engine import IdBatch as JaxIdBatch

    jeng, peng = _engines(group_bytes)
    rng = np.random.default_rng(group_bytes % 89 + ids_per_feature)
    classic = {skey: _state(rng, rows, d) for skey, (rows, d) in peng.storage.items()}
    raw = _batch(peng, 12, ids_per_feature, rng)
    jb = {k: JaxIdBatch(rows=jnp.asarray(r), mask=jnp.asarray(m)) for k, (r, m) in raw.items()}
    pb = {k: IdBatch(rows=torch.tensor(r), mask=torch.tensor(m)) for k, (r, m) in raw.items()}
    jstate = {k: jax.tree.map(jnp.asarray, v) for k, v in classic.items()}
    pstate = {k: _torch(v) for k, v in classic.items()}
    jplans, pplans = jpk.plan_segments(jeng, jb), packed.plan_segments(peng, pb)
    jctx = jpk.gather_fold(jeng, jstate, jb, jplans)
    pctx = packed.gather_fold(peng, pstate, pb, pplans)
    g_np = {skey: [rng.standard_normal(tuple(a.shape)).astype(np.float32) * 1e-2
                   for a in pctx[skey]["acts"]] for skey in pplans}
    jnew = jpk.apply_gradients_packed(jeng, jstate, {k: [jnp.asarray(g) for g in v]
                                                     for k, v in g_np.items()},
                                      jplans, jctx, jb)
    reset_launch_counts()
    pnew = packed.apply_gradients_packed(peng, pstate, {k: [torch.tensor(g) for g in v]
                                                        for k, v in g_np.items()},
                                         pplans, pctx, pb)
    assert pnew is pstate and launch_counts() == dict.fromkeys(KERNELS, 0)
    counts = peng.row_counts(pb)
    for skey in classic:
        want = _np(jax.device_get(jnew[skey]))
        _assert_state(_np(pnew[skey]), want, classic[skey], counts[skey].numpy(),
                      w_atol=STEP_ATOL, g2=STEP_G2)
        assert not peng.accumulator(skey, "cpu").any()


def _evict_pair(opt_j, opt_p, seed):
    slots = [str(7000 + i) for i in range(4)]
    jeng = JaxEngine([jemb(jcat(s, 96), 16, combiner="mean") for s in slots], opt_j,
                     group_tables=True)
    peng = EmbeddingFeatures([embedding_column(category_column(s, 96), 16, combiner="mean")
                              for s in slots], opt_p, group_tables=True)
    assert peng.storage == jeng.storage
    rng = np.random.default_rng(seed)
    classic = {skey: _state(rng, rows, d) for skey, (rows, d) in peng.storage.items()}
    return jeng, peng, classic


@pytest.mark.parametrize("min_show", [3.0, 0.0, -1.0])
def test_evict_matches_jax(min_show):
    """Rows with show >= min_show keep w, g2sum and show bit for bit; the
    others take g2sum at its initial value, show 0 and a fresh w in
    [-0.1, 0.1); min_show = -1 changes nothing."""
    jeng, peng, classic = _evict_pair(JaxSparseAdaGrad(), SparseAdaGrad(), int(min_show) + 4)
    jout = jax.device_get(jeng.evict({k: jax.tree.map(jnp.asarray, v)
                                      for k, v in classic.items()}, min_show,
                                     jax.random.PRNGKey(1)))
    pstate = {k: _torch(v) for k, v in classic.items()}
    ptensors = {k: v["w"] for k, v in pstate.items()}
    pout = peng.evict(pstate, min_show, torch.Generator().manual_seed(1))
    assert pout is pstate and all(pout[k]["w"] is ptensors[k] for k in pout)   # in place
    for skey, before in classic.items():
        want, got = _np(jout[skey]), _np(pout[skey])
        keep = before["show"][:, 0] >= min_show if min_show >= 0 else np.ones(len(got["w"]), bool)
        for name in ("w", "show"):
            np.testing.assert_array_equal(got[name][keep], before[name][keep])
            np.testing.assert_array_equal(got[name][keep], want[name][keep])
        np.testing.assert_array_equal(got["opt"]["g2sum"], want["opt"]["g2sum"])
        np.testing.assert_array_equal(got["show"], want["show"])
        fresh = got["w"][~keep]
        assert ((fresh >= -0.1) & (fresh < 0.1)).all()
        assert (want["w"][~keep] >= -0.1).all() and (want["w"][~keep] < 0.1).all()
        if (~keep).any():
            assert not np.array_equal(fresh, before["w"][~keep])
            np.testing.assert_array_equal(got["opt"]["g2sum"][~keep], np.float32(0.1))
            assert not got["show"][~keep].any()
    if min_show == 3.0:
        assert any((v["show"][:, 0] < 3).any() for v in classic.values())


def test_maybe_evict_takes_the_optimizers_threshold():
    """``maybe_evict`` evicts at ``feature_drop_show`` (2 here) as the JAX
    hook does, and does nothing at the default -1; an Adam engine's m, v
    and t restart with the row."""
    jeng, peng, classic = _evict_pair(JaxSparseAdaGrad(feature_drop_show=2.0),
                                      SparseAdaGrad(feature_drop_show=2.0), 9)
    jout = jax.device_get(jeng.maybe_evict({k: jax.tree.map(jnp.asarray, v)
                                            for k, v in classic.items()}))
    pout = peng.maybe_evict({k: _torch(v) for k, v in classic.items()})
    for skey in classic:
        np.testing.assert_array_equal(pout[skey]["show"].numpy(), jout[skey]["show"])
        np.testing.assert_array_equal(pout[skey]["opt"]["g2sum"].numpy(),
                                      jout[skey]["opt"]["g2sum"])
    _, keep_all, classic = _evict_pair(JaxSparseAdaGrad(), SparseAdaGrad(), 9)
    state = {k: _torch(v) for k, v in classic.items()}
    keep_all.maybe_evict(state)
    for skey, v in classic.items():
        np.testing.assert_array_equal(state[skey]["w"].numpy(), v["w"])
    adam = EmbeddingFeatures([embedding_column(category_column("1", 32), 8)], SparseAdam())
    st = adam.init(torch.Generator().manual_seed(0))
    (skey,) = st
    st[skey]["opt"]["t"].fill_(3.0)
    st[skey]["opt"]["m"].fill_(0.5)
    st[skey]["show"][:10] = 4.0
    adam.evict(st, 1.0, torch.Generator().manual_seed(2))
    assert (st[skey]["opt"]["t"][:10] == 3.0).all() and not st[skey]["opt"]["t"][10:].any()
    assert (st[skey]["opt"]["m"][:10] == 0.5).all() and not st[skey]["opt"]["m"][10:].any()
