"""Port parity for K3 unfold_mean and K4 unfold_rows, each fused with the
scatter-add that consumes it, and for the engine's classic update oracles.

The JAX side builds its (E, 128) [grad | count] payload with
``unfold_mean_ref`` / ``unfold_rows_ref``, scatters it into its (rows/Ps,
128) accumulator (``apply_gradients_packed``, ``packed.py:661-671``) and
unpacks that to (rows, D+1) (``packed.py:714-726``); the port adds straight
into a flat accumulator of a (rows, D) gradient block and a (rows,) count
block, compared here as (rows, D+1) [grad | count] rows.  Tolerance: G atol 1e-6 (each row sums at
most a few dozen float32 gradients of magnitude < 1, in another order);
counts exact (sums of 1.0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.embedding import EmbeddingFeatures as JaxEngine
from recommendsystem_tpu.embedding import IdBatch as JaxIdBatch
from recommendsystem_tpu.embedding import SparseAdam as JaxSparseAdam
from recommendsystem_tpu.embedding import category_column as jcat
from recommendsystem_tpu.embedding import embedding_column as jemb
from recommendsystem_tpu.embedding import packed as jpk
from recommendsystem_tpu_torch.embedding import (EmbeddingFeatures, IdBatch,
                                                 category_column,
                                                 embedding_column, packed)
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.kernels._build import KERNELS

torch.set_num_threads(1)
ATOL = 1e-6
D = 8
ROWS = 28 * 5          # a multiple of the JAX scatter packing (14 rows of D = 8)


def _stream(rng, rows, c, l, b, hot=0.1):
    """l-major ids/mask of c columns: ragged live counts, padding id 0 with
    mask 0, a share ``hot`` of the live ids forced to row 0 (duplicates)."""
    lens = rng.integers(0, l + 1, size=(c, b))
    mask = (np.arange(l)[None, :, None] < lens[:, None, :]).astype(np.float32)
    ids = rng.integers(0, rows, size=(c, l, b)).astype(np.int32)
    ids[rng.uniform(size=ids.shape) < hot] = 0
    ids = ids * mask.astype(np.int32)
    return ids.reshape(-1), mask.reshape(-1)


def _jax_scatter(pay, ids, rows):
    """JAX's scatter of an (E, 128) payload and its unpack to (rows, D+1)."""
    ps = jpk.scatter_pack(D)
    acc = jnp.zeros((rows // ps, 128), jnp.float32).at[ids // ps].add(pay)
    return np.asarray(acc[:, :ps * (D + 1)].reshape(rows, D + 1))


def _acc():
    return torch.zeros(ROWS * (D + 1))


def _views(acc):
    """The (rows, D) gradient sums and (rows, 1) counts the unfold-scatters
    take."""
    return packed.accumulator_views(acc, D)


def _rows(acc):
    """The port's flat accumulator as (rows, D+1) [grad | count] rows."""
    return torch.cat(packed.accumulator_views(acc, D), dim=1).numpy()


def _assert_acc(got, want):
    got = _rows(got)
    np.testing.assert_allclose(got[:, :D], want[:, :D], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[:, D], want[:, D])


@pytest.mark.parametrize("c,l,b", [(24, 5, 16), (1, 5, 128), (3, 2, 40), (2, 5, 7)])
def test_unfold_mean_scatter_matches_jax(c, l, b):
    """C columns of L slots into one accumulator, one K3 call per column as
    ``apply_gradients_packed`` makes them; JAX unfolds all C at once."""
    rng = np.random.default_rng(c * 100 + l * 10 + b)
    ids, mask = _stream(rng, ROWS, c, l, b)
    g = rng.standard_normal((c * b, D)).astype(np.float32)
    want = _jax_scatter(jpk.unfold_mean_ref(jnp.asarray(g), ids, mask, c, l),
                        ids, ROWS)
    tg, tids, tmask = map(torch.from_numpy, (g, ids, mask))
    for fn in (packed.unfold_mean_scatter, packed.unfold_mean_scatter_plain):
        acc = _acc()
        for ci in range(c):
            s = slice(ci * l * b, (ci + 1) * l * b)
            fn(*_views(acc), tg[ci * b:(ci + 1) * b], tids[s], tmask[s], l)
        _assert_acc(acc, want)
    assert want[:, D].sum() == mask.sum()      # every live slot counted once


@pytest.mark.parametrize("e,hot", [(8, 0.1), (200, 0.1), (256, 0.5), (64, 1.0)])
def test_unfold_rows_scatter_matches_jax(e, hot):
    """hot = 1.0: every live entry hits row 0."""
    rng = np.random.default_rng(e)
    ids, mask = _stream(rng, ROWS, 1, 1, e, hot)
    g = rng.standard_normal((e, D)).astype(np.float32)
    want = _jax_scatter(jpk.unfold_rows_ref(jnp.asarray(g), ids, mask), ids, ROWS)
    tg, tids, tmask = map(torch.from_numpy, (g, ids, mask))
    calls = (lambda a: packed.unfold_rows_scatter(*_views(a), tg, tids, tmask),
             lambda a: packed.unfold_rows_scatter_plain(*_views(a), tg, tids, tmask),
             lambda a: packed.unfold_mean_scatter(*_views(a), tg, tids, tmask, 1))  # K4
    for call in calls:
        acc = _acc()
        call(acc)
        _assert_acc(acc, want)


def test_unfold_adds_into_what_the_accumulator_holds():
    rng = np.random.default_rng(1)
    ids, mask = _stream(rng, ROWS, 1, 5, 32)
    g = torch.from_numpy(rng.standard_normal((32, D)).astype(np.float32))
    tids, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    once = _acc()
    packed.unfold_mean_scatter(*_views(once), g, tids, tmask, 5)
    twice = once.clone()
    packed.unfold_mean_scatter(*_views(twice), g, tids, tmask, 5)
    torch.testing.assert_close(twice, 2 * once, rtol=0, atol=ATOL)


def test_cpu_unfold_launches_nothing_and_checks_arguments():
    reset_launch_counts()
    acc = _acc()
    g = torch.ones((4, D))
    ids = torch.zeros(20, dtype=torch.int32)
    mask = torch.ones(20)
    packed.unfold_mean_scatter(*_views(acc), g, ids, mask, 5)
    packed.unfold_rows_scatter(*_views(acc), torch.ones((20, D)), ids, mask)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert _rows(acc)[0, D] == 40
    with pytest.raises(TypeError):
        packed.unfold_mean_scatter(*_views(acc), g, ids.long(), mask, 5)
    with pytest.raises(ValueError):
        packed.unfold_mean_scatter(*_views(acc), g, ids, mask, 4)          # 20 != 4 * 4
    for d in (D - 1, 2):       # D 2: its D+1 divides the accumulator's 1260 floats
        with pytest.raises(ValueError, match="grads"):
            packed.unfold_rows_scatter(*_views(acc), torch.ones((20, d)), ids, mask)
    with pytest.raises(ValueError, match="counts"):
        packed.unfold_rows_scatter(_views(acc)[0], torch.zeros(ROWS + 1, 1),
                                   torch.ones((20, D)), ids, mask)
    with pytest.raises(ValueError, match="rows\\*\\(D\\+1\\)"):
        packed.accumulator_views(torch.zeros(ROWS * (D + 1) + 1), D)
    with pytest.raises(ValueError):
        packed.unfold_rows_scatter(*_views(torch.zeros(2 * ROWS * (D + 1))[::2]),
                                   torch.ones((20, D)), ids, mask)   # not contiguous
    meta = [t.to("meta") for t in (*_views(acc), g, ids, mask)]
    with pytest.raises(ValueError, match="no kernel"):
        packed.unfold_mean_scatter(*meta, 5)


# ---------------------------------------------------------------------------
# the engine's classic update path, the port's oracle of the packed update
# ---------------------------------------------------------------------------

SPEC = [("a", "t1", "mean", 3), ("a2", "t1", "mean", 3), ("b", "t2", "mean", 5),
        ("c", "t3", "mean", 1)]


def _engines_and_batch(b=24, seed=9):
    jeng = JaxEngine([jemb(jcat(t, 64), D, combiner=cb, name=k)
                      for k, t, cb, _ in SPEC], JaxSparseAdam(), group_tables=True)
    peng = EmbeddingFeatures([embedding_column(category_column(t, 64), D,
                                               combiner=cb, name=k)
                              for k, t, cb, _ in SPEC], group_tables=True)
    assert peng.storage == jeng.storage and peng.table_map == jeng.table_map
    rng = np.random.default_rng(seed)
    jbatch, pbatch, raw = {}, {}, {}
    for k, _, _, l in SPEC:
        lens = rng.integers(0, l + 1, size=(b,))
        mask = (np.arange(l)[None, :] < lens[:, None]).astype(np.float32)
        rows = (rng.integers(0, 64, size=(b, l)) * mask).astype(np.int32)
        jbatch[k] = JaxIdBatch(rows=rows, mask=mask)
        pbatch[k] = IdBatch(rows=torch.from_numpy(rows), mask=torch.from_numpy(mask))
        raw[k] = (rng.standard_normal((b, l, D)) * mask[..., None]).astype(np.float32)
    classic = {}
    for skey, (rows, d) in peng.storage.items():
        classic[skey] = {
            "w": rng.standard_normal((rows, d)).astype(np.float32) / 3,
            "opt": {"m": rng.standard_normal((rows, d)).astype(np.float32) * 1e-3,
                    "v": rng.uniform(0, 1e-5, (rows, d)).astype(np.float32),
                    "t": rng.integers(0, 4, (rows, 1)).astype(np.float32)},
            "show": rng.integers(0, 9, (rows, 1)).astype(np.float32)}
    return jeng, peng, jbatch, pbatch, raw, classic


def _torch_state(classic):
    return {k: {"w": torch.tensor(v["w"]),
                "opt": {n: torch.tensor(x) for n, x in v["opt"].items()},
                "show": torch.tensor(v["show"])} for k, v in classic.items()}


def test_row_counts_match_jax():
    jeng, peng, jbatch, pbatch, _, _ = _engines_and_batch()
    want = jeng.row_counts(jbatch)
    got = peng.row_counts(pbatch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_apply_gradients_scatter_matches_jax():
    jeng, peng, jbatch, pbatch, raw, classic = _engines_and_batch()
    jflat = jeng.flatten_raw_grads({k: jnp.asarray(g) for k, g in raw.items()}, jbatch)
    pflat = peng.flatten_raw_grads({k: torch.from_numpy(g) for k, g in raw.items()},
                                   pbatch)
    assert set(pflat) == set(jflat)
    for tkey in jflat:
        for got, want in zip(pflat[tkey], jflat[tkey]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jstate = {k: {"w": jnp.asarray(v["w"]),
                  "opt": {n: jnp.asarray(x) for n, x in v["opt"].items()},
                  "show": jnp.asarray(v["show"])} for k, v in classic.items()}
    want = jeng.apply_gradients_scatter(jstate, jflat)
    pstate = _torch_state(classic)
    got = peng.apply_gradients_scatter(pstate, pflat)
    for skey in classic:
        np.testing.assert_allclose(got[skey]["w"].numpy(), np.asarray(want[skey]["w"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[skey]["opt"]["t"].numpy(),
                                      np.asarray(want[skey]["opt"]["t"]))
        np.testing.assert_array_equal(got[skey]["show"].numpy(),
                                      np.asarray(want[skey]["show"]))
        # the oracle returns a new state and leaves its input alone
        np.testing.assert_array_equal(pstate[skey]["w"].numpy(), classic[skey]["w"])


def test_packed_update_equals_the_classic_scatter_oracle():
    """``apply_gradients_packed`` (K3/K4 + K8 plain versions) on the
    gradients of the folded sums equals ``apply_gradients_scatter`` on the
    same gradients spread over each column's live slots, as the JAX package
    holds its own packed and scatter paths equal (``tests/test_packed.py``)."""
    _, peng, _, pbatch, _, classic = _engines_and_batch(seed=4)
    plans = packed.plan_segments(peng, pbatch)
    state = _torch_state(classic)
    ctx = packed.gather_fold(peng, state, pbatch, plans)
    rng = np.random.default_rng(5)
    g_acts = {s: [torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32))
                  for a in ctx[s]["acts"]] for s in plans}
    raw = {}
    for skey, segs in plans.items():
        for seg, g in zip(segs, g_acts[skey]):
            for ci, k in enumerate(seg.keys):
                b = pbatch[k].rows.shape[0]
                raw[k] = g[ci * b:(ci + 1) * b, None, :] * pbatch[k].mask[..., None]
    want = peng.apply_gradients_scatter(_torch_state(classic),
                                        peng.flatten_raw_grads(raw, pbatch))
    got = packed.apply_gradients_packed(peng, state, g_acts, plans, ctx, pbatch)
    for skey in classic:
        torch.testing.assert_close(got[skey]["w"], want[skey]["w"], rtol=0, atol=1e-6)
        for name in ("m", "v"):
            torch.testing.assert_close(got[skey]["opt"][name], want[skey]["opt"][name],
                                       rtol=1e-5, atol=1e-9)
        torch.testing.assert_close(got[skey]["opt"]["t"], want[skey]["opt"]["t"],
                                   rtol=0, atol=0)
        torch.testing.assert_close(got[skey]["show"], want[skey]["show"],
                                   rtol=0, atol=0)
        assert not peng.accumulator(skey, "cpu").any()
