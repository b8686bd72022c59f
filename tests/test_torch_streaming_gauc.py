"""The port's streaming GAUCs (``train/streaming_gauc.py``) against the JAX
package's on the same numpy inputs, made from a seed: ``mix32`` and the
bucket bit for bit on negative ids, ids >= 2**31 and >= 2**32 (JAX with x64
off takes an id's low 32 bits); out-of-range, infinite and NaN predictions
and labels binned as XLA's saturating float-to-int conversion bins them;
the states and ``compute_parts`` of both GAUCs; the collision-free case
against the port's offline ``search.gauc.group_auc``; additivity, weights
as repetition, hashing's spread, the ``oor`` count and ``_per_task``.

Tolerances: histograms with unit weights exact, with fractional weights
rtol 1e-6 (float32 scatter-adds in another order); ``compute_parts`` rtol
1e-6; against the offline ``group_auc`` the JAX package's own bounds
(1e-4 for ROC, whose offline per-user AUC is rounded to 5 decimals; 1e-5
for the consistency AUC)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.train import streaming_gauc as JSG
from recommendsystem_tpu_torch.search.gauc import group_auc
from recommendsystem_tpu_torch.train.gauc_eval import _per_task
from recommendsystem_tpu_torch.train.streaming_gauc import (StreamingGauc,
                                                            StreamingSpearmanGauc, mix32)

torch.set_num_threads(1)
RTOL = 1e-6
IDS = np.array([0, 1, 7, -1, -2, -5, -(2 ** 31), 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 3,
                2 ** 32 - 1, 2 ** 32, 2 ** 32 + 7, 2 ** 40 + 11, -(2 ** 40) - 3,
                123456789012, 2 ** 62 + 5], np.int64)
# XLA: +-1e10 and +-inf saturate (last bin above, bin 0 below), NaN bins 0
ODD = np.array([1e10, -1e10, np.inf, -np.inf, np.nan, 3.7, -0.5, 0.999999, 1.0, 0.0,
                -1e-30, 0.5], np.float32)


def _as_int64(x):
    return np.asarray(x).astype(np.int64)


def test_mix32_and_buckets_match_jax_bit_for_bit():
    got = mix32(torch.from_numpy(IDS)).numpy()
    want = _as_int64(JSG.mix32(jnp.asarray(IDS)))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 2 ** 32
    for nb in (4096, 1000, 7):
        for hash_ids in (True, False):
            g = StreamingGauc(num_buckets=nb, hash_ids=hash_ids).bucket(torch.from_numpy(IDS))
            w = JSG.StreamingGauc(num_buckets=nb, hash_ids=hash_ids).bucket(jnp.asarray(IDS))
            np.testing.assert_array_equal(g.numpy(), _as_int64(w))


def _roc_states(y, p, u, w=None, **kw):
    m, jm = StreamingGauc(**kw), JSG.StreamingGauc(**kw)
    got = m.update(m.init("cpu"), torch.from_numpy(y), torch.from_numpy(p),
                   torch.from_numpy(u), None if w is None else torch.from_numpy(w))
    want = jm.update(jm.init(), jnp.asarray(y), jnp.asarray(p), jnp.asarray(u),
                     None if w is None else jnp.asarray(w))
    return m, jm, got, want


def test_out_of_range_infinite_and_nan_predictions_bin_as_jax():
    n = ODD.shape[0]
    y = (np.arange(n) % 2).astype(np.float32)
    u = np.arange(n, dtype=np.int64)
    _, _, got, want = _roc_states(y, ODD, u, num_buckets=16, num_bins=8, hash_ids=False)
    for k in ("pos", "neg", "oor"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    bins = (got["pos"] + got["neg"]).argmax(1)[:n].numpy()
    np.testing.assert_array_equal(bins, [7, 0, 7, 0, 0, 7, 0, 7, 7, 0, 0, 4])
    assert got["oor"].item() == 8.0   # 1e10, -1e10, inf, -inf, 3.7, -0.5, 1.0, -1e-30


def test_spearman_bins_predictions_and_labels_as_jax():
    n = ODD.shape[0]
    rng = np.random.default_rng(1)
    u = np.arange(n, dtype=np.int64) % 3
    kw = dict(num_buckets=4, pred_bins=8, label_bins=8, pred_lo=-20.0, pred_hi=181.0,
              label_lo=0.0, label_hi=161.0, hash_ids=False)
    preds = np.concatenate([ODD * 100, ODD]).astype(np.float32)
    labels = np.concatenate([rng.uniform(-10, 200, n), ODD[::-1] * 50]).astype(np.float32)
    uu = np.concatenate([u, u + 1])
    m, jm = StreamingSpearmanGauc(**kw), JSG.StreamingSpearmanGauc(**kw)
    got = m.update(m.init("cpu"), torch.from_numpy(labels), torch.from_numpy(preds),
                   torch.from_numpy(uu))
    want = jm.update(jm.init(), jnp.asarray(labels), jnp.asarray(preds), jnp.asarray(uu))
    np.testing.assert_array_equal(got["hist"].numpy(), np.asarray(want["hist"]))


def _random_case(seed, n=512, n_users=300):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n).astype(np.float32)
    p = rng.uniform(-0.05, 1.05, n).astype(np.float32)
    u = rng.integers(-n_users, n_users, n).astype(np.int64) * (2 ** 31 + 1)
    w = rng.uniform(0.25, 2.0, n).astype(np.float32)
    return y, p, u, w


@pytest.mark.parametrize("weighted", [False, True])
def test_roc_states_and_compute_parts_match_jax(weighted):
    y, p, u, w = _random_case(2)
    m, jm, got, want = _roc_states(y, p, u, w if weighted else None,
                                   num_buckets=64, num_bins=32)
    for k in ("pos", "neg", "oor"):
        if weighted and k != "oor":
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # compute_parts on the same state
    same = {k: jnp.asarray(v.numpy()) for k, v in got.items()}
    for g, j in zip(m.compute_parts(got), jm.compute_parts(same)):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=RTOL)
    np.testing.assert_allclose(m.compute(got).numpy(), np.asarray(jm.compute(want)), rtol=RTOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_spearman_states_and_compute_parts_match_jax(weighted):
    rng = np.random.default_rng(3)
    n = 600
    y = rng.uniform(-5, 170, n).astype(np.float32)
    p = rng.uniform(-25, 190, n).astype(np.float32)
    u = rng.integers(0, 40, n).astype(np.int64) - 20
    w = rng.uniform(0.25, 2.0, n).astype(np.float32) if weighted else None
    kw = dict(num_buckets=16, pred_bins=32, label_bins=16, pred_lo=-20.0, pred_hi=181.0,
              label_lo=0.0, label_hi=161.0)
    m, jm = StreamingSpearmanGauc(**kw), JSG.StreamingSpearmanGauc(**kw)
    got = m.update(m.init("cpu"), torch.from_numpy(y), torch.from_numpy(p),
                   torch.from_numpy(u), None if w is None else torch.from_numpy(w))
    want = jm.update(jm.init(), jnp.asarray(y), jnp.asarray(p), jnp.asarray(u),
                     None if w is None else jnp.asarray(w))
    if weighted:
        np.testing.assert_allclose(got["hist"].numpy(), np.asarray(want["hist"]), rtol=RTOL)
    else:
        np.testing.assert_array_equal(got["hist"].numpy(), np.asarray(want["hist"]))
    same = {"hist": jnp.asarray(got["hist"].numpy())}
    for g, j in zip(m.compute_parts(got), jm.compute_parts(same)):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=RTOL)


def _distinct_bins_case(n=200, n_users=8, num_bins=256, seed=0):
    """Globally distinct prediction bins: no ties, streaming == offline."""
    rng = np.random.default_rng(seed)
    bins = rng.permutation(num_bins)[:n]
    preds = ((bins + 0.5) / num_bins).astype(np.float32)
    labels = rng.integers(0, 2, n).astype(np.float32)
    users = rng.integers(0, n_users, n)
    return labels, preds, users


def test_collision_free_roc_equals_offline_group_auc():
    labels, preds, users = _distinct_bins_case()
    m = StreamingGauc(num_buckets=16, num_bins=256, hash_ids=False)
    s = m.update(m.init("cpu"), torch.from_numpy(labels), torch.from_numpy(preds),
                 torch.from_numpy(users))
    total, nimp = group_auc(labels, preds, users)
    assert abs(m.compute(s).item() - total / nimp) < 1e-4
    t, d = m.compute_parts(s)
    assert d.item() == nimp


def test_collision_free_spearman_equals_offline_group_auc():
    rng = np.random.default_rng(0)
    n, bins = 120, 128
    preds = ((rng.permutation(bins)[:n] + 0.5) / bins).astype(np.float32)
    labels = ((rng.integers(0, bins, n) + 0.5) / bins).astype(np.float32)
    users = rng.integers(0, 6, n)
    m = StreamingSpearmanGauc(num_buckets=8, pred_bins=128, label_bins=128, hash_ids=False)
    s = m.update(m.init("cpu"), torch.from_numpy(labels), torch.from_numpy(preds),
                 torch.from_numpy(users))
    total, nimp = group_auc(labels, preds, users, is_spearman=True)
    assert abs(m.compute(s).item() - total / nimp) < 1e-5


def test_states_are_additive_and_weights_repeat_samples():
    y, p, u, _ = _random_case(4, n=256, n_users=8)
    m = StreamingGauc(num_buckets=16, num_bins=64, hash_ids=False)
    t = lambda a: torch.from_numpy(a)                          # noqa: E731
    full = m.update(m.init("cpu"), t(y), t(p), t(u))
    h = len(y) // 2
    s1 = m.update(m.init("cpu"), t(y[:h]), t(p[:h]), t(u[:h]))
    s2 = m.update(s1, t(y[h:]), t(p[h:]), t(u[h:]))
    for k in full:
        np.testing.assert_array_equal(full[k].numpy(), s2[k].numpy())
    assert not s1["pos"].equal(s2["pos"])                      # update made new tensors
    w = np.where(np.abs(u) % 3 == 0, 3.0, 1.0).astype(np.float32)
    sw = m.update(m.init("cpu"), t(y), t(p), t(u), t(w))
    rep = np.repeat(np.arange(len(y)), w.astype(int))
    sr = m.update(m.init("cpu"), t(y[rep]), t(p[rep]), t(u[rep]))
    np.testing.assert_allclose(m.compute(sw).item(), m.compute(sr).item(), rtol=1e-5)


def test_init_allocates_every_key_on_its_own():
    s = StreamingGauc(num_buckets=4, num_bins=4).init("cpu")
    assert len({v.data_ptr() for v in s.values()}) == 3
    s = StreamingGauc(num_buckets=4, num_bins=4).update(
        s, torch.ones(2), torch.full((2,), 0.3), torch.tensor([1, 2]))
    assert s["pos"].sum().item() == 2.0 and s["neg"].sum().item() == 0.0


def test_hashing_spreads_users():
    b = StreamingGauc(num_buckets=64, hash_ids=True).bucket(torch.arange(1024)).numpy()
    assert (np.bincount(b, minlength=64) > 0).mean() > 0.9


def test_out_of_range_predictions_are_counted():
    g = StreamingGauc(num_buckets=8, num_bins=16)
    y = torch.tensor([1.0, 0.0, 1.0, 0.0])
    u = torch.tensor([1, 2, 3, 4])
    s = g.update(g.init("cpu"), y, torch.tensor([0.5, 0.2, 3.7, -1.0]), u)
    assert s["oor"].item() == 2.0
    s = g.update(s, y, torch.tensor([0.1, 0.2, 0.3, 0.4]), u)
    assert s["oor"].item() == 2.0


def test_gauc_dict_missing_task_raises():
    with pytest.raises(KeyError, match="no metric for task"):
        _per_task({"click": StreamingGauc()}, ("click", "finish"))
    assert set(_per_task({"click": StreamingGauc()}, ("click",))) == {"click"}
