"""bf16 table storage and bf16 Adam moments in the port's engine, optimizers
and kernels' plain versions, against the JAX package.

Ports of the JAX package's own bf16 tests (``tests/test_embedding.py``,
``TestBf16Tables``), each also held to the JAX engine from the same state;
``SparseAdam.state_dtype`` and K8's and K9's plain versions with bf16 w and
moments against the JAX optimizers; K1, K2 and K7's gathering entry over
bf16 tables against the JAX folds and pool; the storage rules
(``storages_packed``, ``state_packable``) against the JAX package's; the
named refusals of other dtypes.

The bf16 rule (``assert_bf16_rule``), stated once for every bf16 test of
the port: a stored bf16 entry equals JAX's, or differs from it by one bf16
ulp where the two packages' float32 values before rounding straddle the
rounding midpoint between the two and differ from each other by at most
1e-6 relative.  The float32 values before rounding come from twins: the
same update run on float32 copies of the same state (a bf16 value widens
to float32 exactly, so a twin computes what the bf16 update computes and
stores it unrounded).  float32 quantities keep the float32 tolerances of
the other port tests: lookups rtol 1e-5, atol 2e-6 (float32 products
summed in another order); t and show exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.embedding import EmbeddingFeatures as JaxEngine
from recommendsystem_tpu.embedding import IdBatch as JaxIdBatch
from recommendsystem_tpu.embedding import SparseAdaGrad as JaxSparseAdaGrad
from recommendsystem_tpu.embedding import SparseAdam as JaxSparseAdam
from recommendsystem_tpu.embedding import category_column as jcat
from recommendsystem_tpu.embedding import embedding_column as jemb
from recommendsystem_tpu.embedding import packed as jpk
from recommendsystem_tpu.kernels.din_pallas import din_pool as jax_din_pool
from recommendsystem_tpu_torch.embedding import (EmbeddingFeatures, IdBatch, SparseAdaGrad,
                                                 SparseAdam, category_column,
                                                 embedding_column, make_sparse_optimizer,
                                                 packed)
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.kernels.din import din_pool_gather

torch.set_num_threads(1)
BF16_RTOL = 1e-6
TOL = dict(rtol=1e-5, atol=2e-6)


def _f32(x) -> np.ndarray:
    """float32 numpy values of a torch tensor or a JAX / numpy array (bf16
    widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_bf16_rule(got, want, got_f32, want_f32=None, rtol=BF16_RTOL, atol=0.0,
                     what="") -> int:
    """The bf16 rule (module docstring): ``got`` and ``want`` are the two
    packages' stored bf16 values, ``got_f32`` and ``want_f32`` their float32
    values before rounding (``want_f32`` may be None where only one side's
    is at hand; then ``got_f32`` must lie within the tolerance of the
    midpoint).  Every entry equal, or one ulp apart with the values before
    rounding on either side of the midpoint and within ``rtol`` (relative
    to ``got_f32``; plus ``atol``) of each other.  Returns the number of
    entries that needed the rule."""
    g, w, p = _f32(got), _f32(want), _f32(got_f32)
    assert g.shape == w.shape == p.shape, (what, g.shape, w.shape, p.shape)
    assert np.array_equal(g, g.astype(np.float32)), what
    differ = g != w
    n = int(differ.sum())
    if not n:
        return 0
    gd, wd, pd = (a[differ].astype(np.float64) for a in (g, w, p))
    bits = lambda a: (a.astype(np.float32).view(np.uint32) >> 16).astype(np.int64)  # noqa: E731
    adjacent = (np.sign(gd) == np.sign(wd)) & (np.abs(bits(gd) - bits(wd)) == 1)
    assert adjacent.all(), (f"{what}: {int((~adjacent).sum())} entries more than one bf16 "
                            f"ulp apart: {gd[~adjacent][:5]} against {wd[~adjacent][:5]}")
    mid = (gd + wd) / 2
    tol = rtol * np.abs(pd) + atol
    ok = (np.sign(pd - mid) != -np.sign(gd - mid))
    if want_f32 is None:
        ok &= np.abs(pd - mid) <= tol
    else:
        jd = _f32(want_f32)[differ].astype(np.float64)
        ok &= (np.sign(jd - mid) != -np.sign(wd - mid)) & (np.abs(pd - jd) <= tol)
    assert ok.all(), (f"{what}: {int((~ok).sum())} of {n} one-ulp entries not at a "
                      f"rounding midpoint: port {pd[~ok][:5]}, stored {gd[~ok][:5]} "
                      f"against {wd[~ok][:5]}")
    return n


def _bf16(a) -> torch.Tensor:
    """A bf16 tensor of float32 values, rounded to nearest even."""
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


def _to_jax(t: torch.Tensor):
    """The same values as a JAX array of the same type."""
    a = jnp.asarray(_f32(t))
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def _port_tables(jstate, float32=False):
    """The port's tables of a JAX classic state, each array in its own type
    (or all float32: a twin)."""
    def conv(a):
        t = torch.tensor(_f32(a))
        return t if float32 or np.asarray(a).dtype.name == "float32" else t.to(torch.bfloat16)
    return {skey: {"w": conv(t["w"]), "opt": {n: conv(x) for n, x in t["opt"].items()},
                   "show": conv(t["show"])}
            for skey, t in jax.device_get(jstate).items()}


def _twin(tables):
    """float32 copies of a port state: the twin whose update stores what the
    bf16 update computes before rounding."""
    return {k: {"w": t["w"].float().clone(),
                "opt": {n: x.float().clone() for n, x in t["opt"].items()},
                "show": t["show"].clone()} for k, t in tables.items()}


def _engines(cols_spec, opt_pair, jax_only=None, **kw):
    """(JAX engine, port engine) over the same columns: ``cols_spec`` holds
    (key, bucket, dim, combiner, seq_max_len) tuples; ``kw`` go to both
    (torch dtypes as JAX's), ``jax_only`` to the JAX engine alone."""
    jcols = [jemb(jcat(k, b), d, combiner=c, seq_max_len=s) for k, b, d, c, s in cols_spec]
    pcols = [embedding_column(category_column(k, b), d, combiner=c, seq_max_len=s)
             for k, b, d, c, s in cols_spec]
    jkw = {k: {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}.get(v, v)
           if isinstance(v, torch.dtype) else v for k, v in kw.items()}
    return (JaxEngine(jcols, opt_pair[0], **jkw, **(jax_only or {})),
            EmbeddingFeatures(pcols, opt_pair[1], **kw))


def _batches(spec):
    """(JAX batch, port batch) of (key, rows, mask) triples."""
    jb = {k: JaxIdBatch(jnp.asarray(r, jnp.int32), jnp.asarray(m, jnp.float32))
          for k, r, m in spec}
    pb = {k: IdBatch(torch.tensor(r, dtype=torch.int32), torch.tensor(m, dtype=torch.float32))
          for k, r, m in spec}
    return jb, pb


def _scatter_step(eng, state, batch, lib):
    """One classic scatter update of sum(out ** 2) in either package."""
    if lib == "jax":
        raw = eng.gather_raw(eng.weights(state), batch)

        def loss(r):
            return sum(jnp.sum(v ** 2) for v in eng.combine_raw(r, batch).values())
        graw = jax.grad(loss)(raw)
        return eng.apply_gradients_scatter(state, eng.flatten_raw_grads(graw, batch))
    raw = {k: v.detach().requires_grad_() for k, v in
           eng.gather_raw(eng.weights(state), batch).items()}
    loss = sum((v ** 2).sum() for v in eng.combine_raw(raw, batch).values())
    graw = dict(zip(raw, torch.autograd.grad(loss, list(raw.values()))))
    return eng.apply_gradients_scatter(state, eng.flatten_raw_grads(graw, batch))


def test_lookup_and_training_in_bf16_storage():
    """The JAX test of the same name, and the same steps held to the JAX
    engine from the same state."""
    spec = [("f1", 64, 8, "mean", None)]
    opts = (JaxSparseAdam(learning_rate=0.05), SparseAdam(learning_rate=0.05))
    # the classic layout on the JAX side: this test reads classic state fields
    jeng, eng = _engines(spec, opts, {"packed_state": False}, table_dtype=torch.bfloat16)
    jtwin, eng32 = _engines(spec, opts, {"packed_state": False})
    jstate = jeng.init(jax.random.PRNGKey(0))
    state = _port_tables(jstate)
    assert state["f1"]["w"].dtype == torch.bfloat16
    assert state["f1"]["opt"]["m"].dtype == torch.float32       # float32 optimizer state
    assert eng.init(torch.Generator().manual_seed(0))["f1"]["w"].dtype == torch.bfloat16

    jb, pb = _batches([("f1", [[3, 9, 0, 0]], [[1, 1, 0, 0]])])
    out = eng.lookup(eng.weights(state), pb)["f1"]
    assert out.dtype == torch.float32                           # computed in float32
    np.testing.assert_allclose(out.numpy(), jeng.lookup(jeng.weights(jstate), jb)["f1"], **TOL)

    raw = eng.gather_raw(eng.weights(state), pb)
    assert raw["f1"].dtype == torch.float32
    new = _scatter_step(eng, state, pb, "port")
    assert new["f1"]["w"].dtype == torch.bfloat16
    w0, w1 = state["f1"]["w"].float(), new["f1"]["w"].float()
    changed = (w1 - w0).abs().sum(1) > 0
    assert changed[3] and changed[9] and int(changed.sum()) == 2
    # against JAX, with both packages' float32 twins for the rule
    jnew = _scatter_step(jeng, jstate, jb, "jax")
    twin = _scatter_step(eng32, _twin(state), pb, "port")
    jtwin_new = _scatter_step(jtwin, jax.tree.map(lambda a: a.astype(jnp.float32), jstate),
                              jb, "jax")
    assert_bf16_rule(new["f1"]["w"], jnew["f1"]["w"], twin["f1"]["w"], jtwin_new["f1"]["w"],
                     what="w")
    for name in ("m", "v", "t"):
        np.testing.assert_allclose(_f32(new["f1"]["opt"][name]),
                                   _f32(jnew["f1"]["opt"][name]), rtol=1e-6, err_msg=name)


def test_auto_table_dtype_mixed_dims():
    """``table_dtype="auto"``: bf16 for rows of D >= 32, float32 for narrow
    rows, in one engine and one scatter step (the JAX test of the same
    name), and the step held to the JAX engine's."""
    spec = [("wide", 64, 32, "mean", None), ("narrow", 64, 8, "mean", None)]
    jeng, eng = _engines(spec, (JaxSparseAdam(learning_rate=0.05),
                                SparseAdam(learning_rate=0.05)),
                         table_dtype="auto", group_tables=True)
    skey_w, skey_n = eng.table_map["wide"][0], eng.table_map["narrow"][0]
    assert eng.storage == jeng.storage and eng.table_map == jeng.table_map
    assert eng.storage_dtype(32) == torch.bfloat16 and eng.storage_dtype(8) == torch.float32
    jstate = jeng.init(jax.random.PRNGKey(0))
    state = _port_tables(jeng.classic_state(jstate))
    assert state[skey_w]["w"].dtype == torch.bfloat16
    assert state[skey_n]["w"].dtype == torch.float32
    jb, pb = _batches([("wide", [[3, 5]], [[1, 1]]), ("narrow", [[7, 0]], [[1, 0]])])
    new = _scatter_step(eng, state, pb, "port")
    assert new[skey_w]["w"].dtype == torch.bfloat16
    assert new[skey_n]["w"].dtype == torch.float32
    for skey, touched in ((skey_w, [3, 5]), (skey_n, [7])):
        d = (new[skey]["w"].float() - state[skey]["w"].float()).abs().sum(1)
        assert bool((d[touched] > 0).all()) and int((d > 0).sum()) == len(touched)
    jnew = jeng.classic_state(_scatter_step(jeng, jstate, jb, "jax"))
    eng32 = EmbeddingFeatures(list(eng.columns.values()), eng.sparse_opt, group_tables=True)
    twin = _scatter_step(eng32, _twin(state), pb, "port")
    assert_bf16_rule(new[skey_w]["w"], jnew[skey_w]["w"], twin[skey_w]["w"], what="wide w")
    np.testing.assert_allclose(_f32(new[skey_n]["w"]), _f32(jnew[skey_n]["w"]), rtol=0,
                               atol=1e-7)


def test_dense_path_bf16():
    """The dense update over a bf16 table (the JAX test of the same name):
    the gradient arrives in bf16, as JAX's, and w stays bf16, moving the
    touched rows only; held to JAX's dense update from the same state."""
    spec = [("f1", 32, 8, "mean", None)]
    jeng, eng = _engines(spec, (JaxSparseAdaGrad(learning_rate=0.05),
                                SparseAdaGrad(learning_rate=0.05)),
                         table_dtype=torch.bfloat16)
    jstate = jeng.init(jax.random.PRNGKey(0))
    state = _port_tables(jstate)
    jb, pb = _batches([("f1", [[1, 2]], [[1, 1]])])
    w = {k: v.detach().requires_grad_() for k, v in eng.weights(state).items()}
    (g,) = torch.autograd.grad((eng.lookup(w, pb)["f1"] ** 2).sum(), [w["f1"]])
    assert g.dtype == torch.bfloat16
    new = eng.apply_gradients(state, {"f1": g}, eng.row_counts(pb))
    assert new["f1"]["w"].dtype == torch.bfloat16
    jg = jax.grad(lambda ws: jnp.sum(jeng.lookup(ws, jb)["f1"] ** 2))(jeng.weights(jstate))
    assert jg["f1"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(g), _f32(jg["f1"]))
    jnew = jeng.apply_gradients(jstate, jg, jeng.row_counts(jb))
    changed = (new["f1"]["w"].float() - state["f1"]["w"].float()).abs().sum(1) > 0
    assert changed[1] and changed[2] and int(changed.sum()) == 2
    eng32 = EmbeddingFeatures(list(eng.columns.values()), eng.sparse_opt)
    twin = eng32.apply_gradients(_twin(state), {"f1": g}, eng.row_counts(pb))
    assert_bf16_rule(new["f1"]["w"], jnew["f1"]["w"], twin["f1"]["w"], what="w")
    np.testing.assert_allclose(_f32(new["f1"]["opt"]["g2sum"]), _f32(jnew["f1"]["opt"]["g2sum"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(_f32(new["f1"]["show"]), _f32(jnew["f1"]["show"]))


@pytest.mark.parametrize("opt", [SparseAdam(), SparseAdaGrad()], ids=["adam", "adagrad"])
def test_table_init_draws_in_float32_and_casts(opt):
    gen = lambda: torch.Generator().manual_seed(5)      # noqa: E731
    w32 = opt.table_init(gen(), (64, 32))
    w16 = opt.table_init(gen(), (64, 32), dtype=torch.bfloat16)
    assert w16.dtype == torch.bfloat16
    assert torch.equal(w16, w32.to(torch.bfloat16))
    spec = [embedding_column(category_column("a", 64), 32), embedding_column(
        category_column("b", 64), 8)]
    st = EmbeddingFeatures(spec, opt, table_dtype="auto").init(gen())
    st32 = EmbeddingFeatures(spec, opt).init(gen())
    for k in st:
        assert torch.equal(st[k]["w"], st32[k]["w"].to(st[k]["w"].dtype))
        assert st[k]["show"].dtype == torch.float32


def _moments_state(rng, rows, d, w_dtype, m_dtype):
    w = torch.tensor(rng.standard_normal((rows, d)).astype(np.float32) / 3).to(w_dtype)
    m = torch.tensor(rng.standard_normal((rows, d)).astype(np.float32) * 1e-3).to(m_dtype)
    v = torch.tensor(rng.uniform(0, 1e-5, (rows, d)).astype(np.float32)).to(m_dtype)
    t = torch.tensor(rng.integers(0, 5, (rows, 1)).astype(np.float32))
    show = torch.tensor(rng.integers(0, 9, (rows, 1)).astype(np.float32))
    cnt = np.where(rng.uniform(size=(rows, 1)) < 0.4, rng.integers(1, 5, (rows, 1)), 0)
    g = rng.standard_normal((rows, d)).astype(np.float32) * 1e-2 * (cnt > 0)
    acc = torch.tensor(np.concatenate([g.ravel(), cnt.astype(np.float32).ravel()]))
    return {"w": w, "opt": {"m": m, "v": v, "t": t}, "show": show}, acc


@pytest.mark.parametrize("w_dtype,m_dtype", [(torch.bfloat16, torch.float32),
                                             (torch.bfloat16, torch.bfloat16),
                                             (torch.float32, torch.bfloat16)],
                         ids=["bf16_w", "bf16_w_moments", "bf16_moments"])
def test_k8_plain_version_with_bf16_matches_jax(w_dtype, m_dtype):
    """K8's plain version over bf16 w and/or bf16 moments against the JAX
    ``SparseAdam(state_dtype=...).update`` on the same state: the step
    comes from the unrounded moments, only the stored copies round; rows
    whose count is 0 stay bit-identical; t and show exact."""
    rng = np.random.default_rng(3)
    rows, d = 14 * 12, 8
    opt = SparseAdam(learning_rate=1e-2, state_dtype=m_dtype)
    jopt = JaxSparseAdam(learning_rate=1e-2, state_dtype=_to_jax(
        torch.zeros(1, dtype=m_dtype)).dtype)
    tstate, acc = _moments_state(rng, rows, d, w_dtype, m_dtype)
    before = {k: (v.clone() if k != "opt" else {n: x.clone() for n, x in v.items()})
              for k, v in tstate.items()}
    twin = _twin({"s": tstate})["s"]
    reset_launch_counts()
    packed.sparse_adam_update(opt, tstate, acc.clone())
    packed.sparse_adam_update(SparseAdam(learning_rate=1e-2), twin, acc.clone())
    assert set(launch_counts().values()) == {0}
    g, cnt = acc[:rows * d].view(rows, d).numpy(), acc[rows * d:].view(rows, 1).numpy()
    jw, jst = jopt.update(jnp.asarray(_f32(before["w"])), jnp.asarray(g),
                          {n: _to_jax(x) for n, x in before["opt"].items()},
                          jnp.asarray((cnt > 0).astype(np.float32)))
    # JAX's float32 twin: its moments before they are cast to bf16
    _, jst32 = JaxSparseAdam(learning_rate=1e-2).update(
        jnp.asarray(_f32(before["w"])), jnp.asarray(g),
        {n: jnp.asarray(_f32(x)) for n, x in before["opt"].items()},
        jnp.asarray((cnt > 0).astype(np.float32)))
    assert tstate["w"].dtype == w_dtype and tstate["opt"]["m"].dtype == m_dtype
    if w_dtype == torch.bfloat16:
        assert_bf16_rule(tstate["w"], _to_jax(torch.tensor(_f32(jw))).astype(jnp.bfloat16),
                         twin["w"], jw, what="w")
    else:
        np.testing.assert_allclose(tstate["w"].numpy(), _f32(jw), rtol=0, atol=1e-7)
    for name in ("m", "v"):
        if m_dtype == torch.bfloat16:
            assert jst[name].dtype == jnp.bfloat16
            assert_bf16_rule(tstate["opt"][name], jst[name], twin["opt"][name], jst32[name],
                             what=name)
        else:
            np.testing.assert_allclose(_f32(tstate["opt"][name]), _f32(jst[name]), rtol=1e-6)
    np.testing.assert_array_equal(tstate["opt"]["t"].numpy(), _f32(jst["t"]))
    np.testing.assert_array_equal(tstate["show"].numpy(), _f32(before["show"]) + cnt)
    dead = torch.tensor(cnt[:, 0] == 0)
    for got, was in ((tstate["w"], before["w"]), (tstate["opt"]["m"], before["opt"]["m"]),
                     (tstate["opt"]["v"], before["opt"]["v"])):
        assert torch.equal(got[dead], was[dead])
    # the step is taken from the moments before they round: a step from
    # the rounded moments would move w otherwise
    if m_dtype == torch.bfloat16:
        m_r = twin["opt"]["m"].to(torch.bfloat16).float()
        assert not torch.equal(m_r, twin["opt"]["m"])


def test_k9_plain_version_with_bf16_w_matches_jax():
    """K9's plain version over a bf16 w against the JAX
    ``SparseAdaGrad.update`` on the same state (g2sum float32)."""
    rng = np.random.default_rng(4)
    rows, d = 200, 32
    opt, jopt = SparseAdaGrad(learning_rate=0.05), JaxSparseAdaGrad(learning_rate=0.05)
    w = _bf16(rng.uniform(-0.1, 0.1, (rows, d)))
    g2 = torch.tensor(rng.uniform(0.1, 0.5, (rows, 1)).astype(np.float32))
    show = torch.zeros((rows, 1))
    cnt = np.where(rng.uniform(size=(rows, 1)) < 0.5, 1, 0).astype(np.float32)
    g = (rng.standard_normal((rows, d)) * 1e-2 * cnt).astype(np.float32)
    acc = torch.tensor(np.concatenate([g.ravel(), cnt.ravel()]))
    tstate = {"w": w.clone(), "opt": {"g2sum": g2.clone()}, "show": show.clone()}
    twin = _twin({"s": tstate})["s"]
    packed.sparse_adagrad_update(opt, tstate, acc.clone())
    packed.sparse_adagrad_update(opt, twin, acc.clone())
    jw, jst = jopt.update(jnp.asarray(_f32(w)), jnp.asarray(g), {"g2sum": jnp.asarray(_f32(g2))},
                          jnp.asarray(cnt))
    assert tstate["w"].dtype == torch.bfloat16
    assert_bf16_rule(tstate["w"], jnp.asarray(jw).astype(jnp.bfloat16), twin["w"], jw, what="w")
    np.testing.assert_allclose(tstate["opt"]["g2sum"].numpy(), _f32(jst["g2sum"]), rtol=1e-6)
    dead = torch.tensor(cnt[:, 0] == 0)
    assert torch.equal(tstate["w"][dead], w[dead])


@pytest.mark.parametrize("d", [8, 16, 32, 56])
def test_folds_read_bf16_tables(d):
    """K1 and K2's plain versions over a bf16 table against the JAX folds
    over the same bf16 rows (widened to float32 at use); a grouped call may
    mix float32 and bf16 members."""
    rng = np.random.default_rng(d)
    rows = 16 * 21
    w = _bf16(rng.standard_normal((rows, d)) / np.sqrt(d))
    c, l, b = 2, 5, 12
    ids = rng.integers(0, rows, size=(c * l * b,)).astype(np.int32)
    mask = (rng.uniform(size=c * l * b) > 0.3).astype(np.float32)
    wide = jpk.pack_table(_to_jax(w))[jnp.asarray(ids) // jpk.gather_pack(d)]
    assert wide.dtype == jnp.bfloat16
    want_mean = jpk.fold_mean_ref(wide, jnp.asarray(ids), jnp.asarray(mask), c, l, d)
    want_rows = jpk.fold_rows_ref(wide, jnp.asarray(ids), jnp.asarray(mask), d)
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    got_mean = packed.fold_mean(w, ti, tm, c, l)
    got_rows = packed.fold_rows(w, ti, tm)
    assert got_mean.dtype == got_rows.dtype == torch.float32
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(want_mean), **TOL)
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(want_rows))
    w32 = torch.tensor(rng.standard_normal((rows, d)).astype(np.float32))
    mixed = packed.fold_mean_group([(w, ti, tm, c, l), (w32, ti, tm, c, l)])
    assert torch.equal(mixed[0], got_mean)
    assert torch.equal(mixed[1], packed.fold_mean_plain(w32, ti, tm, c, l))
    mixed = packed.fold_rows_group([(w32, ti, tm), (w, ti, tm)])
    assert torch.equal(mixed[1], got_rows)


def test_din_gather_reads_a_bf16_table():
    """K7's gathering entry over a bf16 (rows, 32) table against the JAX
    ``din_pool`` (as the JAX package's tests run it on the CPU) on the facts
    that the JAX fold reference gathers from the packed bf16 table."""
    rng = np.random.default_rng(7)
    b, t, h, rows = 6, 10, 16, 96
    table = _bf16(rng.standard_normal((rows, 32)) / 4)
    ids = rng.integers(0, rows, size=(b, t)).astype(np.int32)
    mask = (rng.uniform(size=(b, t)) > 0.3).astype(np.float32)
    mask[2] = 0.0                       # a sample with no live behaviour
    q = rng.standard_normal((b, h)).astype(np.float32)
    w1 = (rng.standard_normal((4 * h, 16)) / 8).astype(np.float32)
    b1 = (rng.standard_normal(16) / 8).astype(np.float32)
    w2 = (rng.standard_normal((16, 1)) / 4).astype(np.float32)
    b2 = (rng.standard_normal(1) / 4).astype(np.float32)
    got = din_pool_gather(torch.from_numpy(q), table, torch.from_numpy(ids),
                          torch.from_numpy(mask), (16, 32),
                          *map(torch.from_numpy, (w1, b1, w2, b2)))
    # the JAX sequence path: K2's reference rows of the packed bf16 table
    flat, m = jnp.asarray(ids.reshape(-1)), jnp.asarray(mask.reshape(-1))
    wide = jpk.pack_table(_to_jax(table))[flat // jpk.gather_pack(32)]
    facts = jpk.fold_rows_ref(wide, flat, m, 32)[:, 16:32].reshape(b, t, h)
    want = jax_din_pool(jnp.asarray(q), facts, jnp.asarray(mask),
                        jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16, "auto"])
@pytest.mark.parametrize("packed_flag", [True, False])
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16, None])
def test_storage_rules_match_jax(table_dtype, packed_flag, state_dtype):
    """Storages, offsets and ``state_packable`` equal the JAX engine's for
    Adam (float32 or bf16 moments) and AdaGrad (``state_dtype`` None)
    engines of mixed widths, packed or not; ``storages_packed`` is the JAX
    engine's split, but for the D-136 storage, which the JAX package's
    128-lane layout leaves classic and the port folds where the engine is
    built packed (its own rule)."""
    spec = [(f"s{i}", 100 + 13 * i, d, "mean", None)
            for i, d in enumerate((8, 8, 32, 32, 56, 136))]
    if state_dtype is None:
        pair = (JaxSparseAdaGrad(), SparseAdaGrad())
    else:
        pair = (JaxSparseAdam(state_dtype=jnp.bfloat16 if state_dtype == torch.bfloat16
                              else jnp.float32), SparseAdam(state_dtype=state_dtype))
    jeng, eng = _engines(spec, pair, table_dtype=table_dtype, packed=packed_flag,
                         group_tables=True, max_group_bytes=1 << 16)
    assert eng.storage == jeng.storage and eng.table_map == jeng.table_map
    jax_pk, jax_classic = jpk.storages_packed(jeng)
    wide = {k for k, (_, d) in eng.storage.items() if d == 136}
    assert wide and wide <= set(jax_classic)
    folded = wide if packed_flag else set()
    assert packed.storages_packed(eng) == (
        [k for k in eng.storage if k in jax_pk or k in folded],
        [k for k in jax_classic if k not in folded])
    for skey in eng.storage:
        assert packed.state_packable(eng, skey) == jpk.state_packable(jeng, skey), skey


def test_kernels_refuse_other_dtypes():
    """Tables and moments of another type than float32 or bf16 raise a named
    ``TypeError``; so do m and v of two types; an engine refuses an unknown
    ``table_dtype`` by name."""
    w16 = torch.zeros((64, 8), dtype=torch.float16)
    ids, mask = torch.zeros(10, dtype=torch.int32), torch.ones(10)
    with pytest.raises(TypeError, match="bfloat16"):
        packed.fold_rows(w16, ids, mask)
    with pytest.raises(TypeError, match="bfloat16"):
        packed.fold_mean(w16, ids, mask, 1, 5)
    rng = np.random.default_rng(0)
    tstate, acc = _moments_state(rng, 16, 8, torch.bfloat16, torch.bfloat16)
    bad = dict(tstate, w=tstate["w"].half())
    with pytest.raises(TypeError, match="w: dtype"):
        packed.sparse_adam_update(SparseAdam(), bad, acc)
    bad = dict(tstate, opt=dict(tstate["opt"], v=tstate["opt"]["v"].float()))
    with pytest.raises(TypeError, match="share one type"):
        packed.sparse_adam_update(SparseAdam(), bad, acc)
    bad = {"w": tstate["w"], "opt": {"g2sum": torch.zeros((16, 1), dtype=torch.bfloat16)},
           "show": tstate["show"]}
    with pytest.raises(TypeError, match="g2sum"):
        packed.sparse_adagrad_update(SparseAdaGrad(), bad, acc)
    q = torch.zeros((2, 16))
    w = [torch.zeros((64, 16)), torch.zeros(16), torch.zeros((16, 1)), torch.zeros(1)]
    with pytest.raises(TypeError, match="table"):
        din_pool_gather(q, torch.zeros((8, 32), dtype=torch.float16),
                        torch.zeros((2, 3), dtype=torch.int32), torch.ones((2, 3)),
                        (0, 16), *w)
    with pytest.raises(ValueError, match="table_dtype"):
        EmbeddingFeatures([embedding_column(category_column("a", 8), 8)],
                          table_dtype=torch.float16)


def test_evict_keeps_each_fields_type():
    """``evict`` over bf16 w and bf16 moments: fresh rows drawn in w's type,
    fresh moments in theirs; kept rows bit-identical."""
    spec = [embedding_column(category_column("a", 64), 32, combiner="mean")]
    eng = EmbeddingFeatures(spec, SparseAdam(state_dtype=torch.bfloat16),
                            table_dtype=torch.bfloat16)
    state = eng.init(torch.Generator().manual_seed(0))
    st = state["a"]
    st["opt"]["m"].fill_(0.5)
    st["show"][:32] = 3.0
    before = st["w"].clone()
    eng.evict(state, 1.0, torch.Generator().manual_seed(9))
    assert st["w"].dtype == st["opt"]["m"].dtype == torch.bfloat16
    assert torch.equal(st["w"][:32], before[:32])
    fresh = SparseAdam().table_init(torch.Generator().manual_seed(9), tuple(st["w"].shape),
                                    dtype=torch.bfloat16)
    assert torch.equal(st["w"][32:], fresh[32:])
    assert bool((st["opt"]["m"][:32] == 0.5).all())
    assert not st["opt"]["m"][32:].any() and not st["show"][32:].any()


def test_make_sparse_optimizer():
    assert make_sparse_optimizer("Adam", learning_rate=0.1) == SparseAdam(learning_rate=0.1)
    assert make_sparse_optimizer("adagrad") == SparseAdaGrad()
    assert make_sparse_optimizer("adam", state_dtype=torch.bfloat16).state_dtype == \
        torch.bfloat16
    with pytest.raises(ValueError, match="unknown sparse optimizer"):
        make_sparse_optimizer("sgd")
