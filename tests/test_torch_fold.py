"""Port parity for K1 fold_mean / K2 fold_rows and the fused lookup.

Tolerance: atol 1e-6 — each output is a sum of at most 5 float32 products
of magnitude < 1, taken in another order than the JAX reference's
selection matmul."""

import numpy as np
import pytest
import torch

import jax
from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.embedding import (EmbeddingFeatures as JaxEngine,
                                           SparseAdam)
from recommendsystem_tpu.embedding import category_column as jcat
from recommendsystem_tpu.embedding import embedding_column as jemb
from recommendsystem_tpu.embedding import packed as jpk
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.embedding import EmbeddingFeatures, packed
from recommendsystem_tpu_torch.embedding import category_column, embedding_column
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.kernels._build import KERNELS
from recommendsystem_tpu_torch.models import create_model

torch.set_num_threads(1)
ATOL = 1e-6


def _stream(rng, rows, c, l, b):
    """l-major ids/mask of c columns: ragged live counts, padding id 0 (the
    hot row) with mask 0, and some live ids forced to row 0 too."""
    lens = rng.integers(0, l + 1, size=(c, b))
    mask = (np.arange(l)[None, :, None] < lens[:, None, :]).astype(np.float32)
    ids = rng.integers(0, rows, size=(c, l, b)).astype(np.int32)
    ids[rng.uniform(size=ids.shape) < 0.1] = 0
    ids = ids * mask.astype(np.int32)
    return ids.reshape(-1), mask.reshape(-1)


def _jax_wide(w, ids, pack):
    """Gathered 128-lane rows as the JAX path feeds its fold kernels."""
    d = w.shape[1]
    if pack == "gather":
        wp, p = jpk.pack_table(w), jpk.gather_pack(d)
    else:   # the packed-state layout autoint's tables live in
        wp, p = jpk._pack_cols(w, None, d), jpk.scatter_pack(d)
    return wp[ids // p]


@pytest.mark.parametrize("pack", ["gather", "scatter"])
@pytest.mark.parametrize("c,l,b", [(24, 5, 16), (1, 5, 128), (3, 2, 40)])
def test_fold_mean_matches_jax_ref(c, l, b, pack):
    rng = np.random.default_rng(c * 100 + l)
    rows, d = 336, 8
    w = (rng.standard_normal((rows, d)) / np.sqrt(d)).astype(np.float32)
    ids, mask = _stream(rng, rows, c, l, b)
    want = jpk.fold_mean_ref(_jax_wide(w, ids, pack), ids, mask, c, l, d, pack)
    table, tids, tmask = map(torch.from_numpy, (w, ids, mask))
    for got in (packed.fold_mean_plain(table, tids, tmask, c, l),
                packed.fold_mean(table, tids, tmask, c, l)):
        assert got.shape == (c * b, d) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("pack", ["gather", "scatter"])
@pytest.mark.parametrize("e", [8, 200, 256])
def test_fold_rows_matches_jax_ref(e, pack):
    rng = np.random.default_rng(e)
    rows, d = 336, 8
    w = (rng.standard_normal((rows, d)) / np.sqrt(d)).astype(np.float32)
    ids, mask = _stream(rng, rows, 1, 1, e)
    want = jpk.fold_rows_ref(_jax_wide(w, ids, pack), ids, mask, d, pack)
    table, tids, tmask = map(torch.from_numpy, (w, ids, mask))
    for got in (packed.fold_rows_plain(table, tids, tmask),
                packed.fold_rows(table, tids, tmask),
                packed.fold_mean(table, tids, tmask, 1, 1)):   # l == 1 -> K2
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_cpu_wrappers_launch_nothing():
    reset_launch_counts()
    table = torch.randn(64, 8)
    ids = torch.zeros(20, dtype=torch.int32)
    mask = torch.ones(20)
    packed.fold_mean(table, ids, mask, 2, 5)
    packed.fold_rows(table, ids, mask)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def test_wrappers_check_arguments_and_never_fall_back():
    table = torch.randn(64, 8)
    ids = torch.zeros(10, dtype=torch.int32)
    mask = torch.ones(10)
    with pytest.raises(TypeError):
        packed.fold_rows(table, ids.long(), mask)
    with pytest.raises(TypeError):
        packed.fold_rows(table.double(), ids, mask)
    with pytest.raises(ValueError):
        packed.fold_rows(table, ids, mask[:5])
    with pytest.raises(ValueError):
        packed.fold_mean(table, ids, mask, 3, 5)     # 10 ids != 3 * 5 * B
    with pytest.raises(ValueError):
        packed.fold_rows(table.t(), ids, mask)       # not contiguous
    # a tensor that is neither on the CPU nor on CUDA gets no plain version
    meta = [t.to("meta") for t in (table, ids, mask)]
    with pytest.raises(ValueError, match="no kernel"):
        packed.fold_rows(*meta)


def _bridged_engines(max_group_bytes):
    """A small autoint-shaped engine in both packages, tables from the JAX
    init (packed-state storages) carried across by the bridge's path."""
    slots = [str(1000 + i) for i in range(24)]
    jeng = JaxEngine([jemb(jcat(s, 256), 8, combiner="mean", name=s) for s in slots],
                     SparseAdam(), group_tables=True,
                     max_group_bytes=max_group_bytes)
    peng = EmbeddingFeatures([embedding_column(category_column(s, 256), 8,
                                               combiner="mean", name=s)
                              for s in slots],
                             group_tables=True, max_group_bytes=max_group_bytes)
    assert peng.storage == jeng.storage and peng.table_map == jeng.table_map
    jstate = jeng.init(jax.random.PRNGKey(0))
    assert all(jpk.is_packed_state(t) for t in jstate.values())
    ptables = {k: {"w": torch.from_numpy(np.array(v))}
               for k, v in jeng.weights(jstate).items()}
    return jeng, jstate, peng, ptables


@pytest.mark.parametrize("ids_per_feature", [5, 1])
@pytest.mark.parametrize("max_group_bytes", [10 << 20, 1])
def test_lookup_packed_matches_jax(max_group_bytes, ids_per_feature):
    """10 MB groups all 24 tables into one storage (C = 24 per fold);
    1 byte gives every table its own storage (C = 1, as at full width)."""
    jeng, jstate, peng, ptables = _bridged_engines(max_group_bytes)
    jbundle = jax_create_model("autoint", bucket_size=256)
    pbundle = create_model("autoint", bucket_size=256, device="cpu")
    jbatch, _, _, _ = jax_synthetic_batch(jbundle, 48, seed=5,
                                          ids_per_feature=ids_per_feature)
    pbatch, _, _, _ = synthetic_batch(pbundle, 48, seed=5,
                                      ids_per_feature=ids_per_feature)
    for k in jbatch:
        np.testing.assert_array_equal(pbatch[k].rows.numpy(), jbatch[k].rows)
        np.testing.assert_array_equal(pbatch[k].mask.numpy(), jbatch[k].mask)
    want = jpk.lookup_packed(jeng, jstate, jbatch)
    got = packed.lookup_packed(peng, ptables, pbatch)
    oracle = peng.lookup(peng.weights(ptables), pbatch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(got[k].numpy(), oracle[k].numpy(),
                                   rtol=0, atol=ATOL)



def test_lookup_packed_mixed_columns_match_jax():
    """Every kind of column the engine takes, in both packages: mean, sum
    and sqrtn combiners at ids widths 1, 3 and 5 in one storage, two columns
    on one table, a sequence column (K2 over b-major rows) and a D = 128
    table that the fold path cannot take (classic gather)."""
    from recommendsystem_tpu.embedding import IdBatch as JaxIdBatch
    from recommendsystem_tpu_torch.embedding import IdBatch

    spec = [("a", "t1", 8, "mean", 3), ("a2", "t1", 8, "mean", 3),
            ("b", "t2", 8, "sum", 5), ("c", "t3", 8, "sqrtn", 1),
            ("s", "t4", 8, None, 4), ("w", "t5", 128, "mean", 2)]
    jeng = JaxEngine([jemb(jcat(t, 64), d, combiner=cb, name=k,
                           seq_max_len=l if cb is None else None)
                      for k, t, d, cb, l in spec], SparseAdam(), group_tables=True)
    peng = EmbeddingFeatures([embedding_column(category_column(t, 64), d,
                                               combiner=cb, name=k,
                                               seq_max_len=l if cb is None else None)
                              for k, t, d, cb, l in spec], group_tables=True)
    assert peng.storage == jeng.storage and peng.table_map == jeng.table_map
    pk, classic = packed.storages_packed(peng)
    assert (pk, classic) == tuple(jpk.storages_packed(jeng))
    assert len(pk) >= 1 and len(classic) == 1
    jstate = jeng.init(jax.random.PRNGKey(1))
    ptables = {k: {"w": torch.from_numpy(np.array(v))}
               for k, v in jeng.weights(jstate).items()}

    rng = np.random.default_rng(9)
    b = 24
    jbatch, pbatch = {}, {}
    for k, _, _, _, l in spec:
        lens = rng.integers(0, l + 1, size=(b,))
        mask = (np.arange(l)[None, :] < lens[:, None]).astype(np.float32)
        rows = (rng.integers(0, 64, size=(b, l)) * mask).astype(np.int32)
        jbatch[k] = JaxIdBatch(rows=rows, mask=mask)
        pbatch[k] = IdBatch(rows=torch.from_numpy(rows), mask=torch.from_numpy(mask))
    want = jpk.lookup_packed(jeng, jstate, jbatch)
    got = packed.lookup_packed(peng, ptables, pbatch)
    oracle = peng.lookup(peng.weights(ptables), pbatch)
    assert set(got) == set(want) == {k for k, *_ in spec}
    for k in want:
        if k == "s":
            (g, gm), (w, wm), (o, _) = got[k], want[k], oracle[k]
            np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        else:
            g, w, o = got[k], want[k], oracle[k]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
        np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=0, atol=ATOL)
