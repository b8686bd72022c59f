"""The port's streaming metrics (``train/metrics.py``) against the JAX
package's on the same numpy inputs, made from a seed: every metric with
weights None, one array and a dict per task; the AUC thresholds bit for
bit, and predictions lying on them; ``bin_accuracy``'s ties; states that
share no storage (between keys, between ctr's two tasks, and between an
update's input and output); the device check.

Tolerances: counts (unit weights, 0/1 labels) exact; weighted sums and sums
of predictions rtol 1e-5 (float32 sums in another order); ``compute`` rtol
1e-6 on equal states."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.models.staytime import BIN_LIST as JAX_BIN_LIST
from recommendsystem_tpu.train import metrics as JM
from recommendsystem_tpu_torch.core.config import synthetic_ctr_config
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.ctr import T_CLICK, T_EFFECT
from recommendsystem_tpu_torch.models.staytime import BIN_LIST
from recommendsystem_tpu_torch.train import metrics as M

torch.set_num_threads(1)
SUM_RTOL = 1e-5
COMPUTE_RTOL = 1e-6
B = 96
# keys that count examples when the weights are 1 and the labels 0 or 1
COUNT_KEYS = {"correct", "total", "tp", "fp", "tn", "fn", "label", "n"}


def _pairs():
    """(port metrics, JAX metrics) by task: two binary tasks and the
    staytime stay head."""
    binary = lambda mod: [mod.binary_accuracy(), mod.auc(), mod.copc(), mod.ctr()]  # noqa: E731
    return ({"a": binary(M), "b": binary(M),
             "st": [M.bin_accuracy(BIN_LIST), M.ev_mae(), M.ev_mse()]},
            {"a": binary(JM), "b": binary(JM),
             "st": [JM.bin_accuracy(JAX_BIN_LIST), JM.ev_mae(), JM.ev_mse()]})


def _data(seed, b=B):
    """Labels and outputs as numpy: binary tasks (B, 1); the stay head's
    (B, 401) distribution and value, its label's last column a watch time."""
    rng = np.random.default_rng(seed)
    y, p = {}, {}
    for t in ("a", "b"):
        y[t] = rng.integers(0, 2, (b, 1)).astype(np.float32)
        p[t] = rng.uniform(0, 1, (b, 1)).astype(np.float32)
    logits = rng.standard_normal((b, 400)).astype(np.float32)
    dist = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    ev = (dist @ np.asarray(BIN_LIST, np.float32))[:, None]
    p["st"] = np.concatenate([dist, ev], 1).astype(np.float32)
    wt = rng.uniform(0, 160, (b, 1)).astype(np.float32)
    y["st"] = np.concatenate([np.zeros((b, 400), np.float32), wt], 1)
    return y, p


def _weights(kind, seed, b=B):
    rng = np.random.default_rng(seed + 1000)
    if kind == "none":
        return None
    if kind == "array":
        return rng.uniform(0.25, 2.0, (b, 1)).astype(np.float32)
    return {t: rng.uniform(0.25, 2.0, (b, 1)).astype(np.float32) for t in ("a", "b", "st")}


def _to_torch(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: torch.from_numpy(v) for k, v in x.items()}
    return torch.from_numpy(x)


def _to_jax(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: jnp.asarray(v) for k, v in x.items()}
    return jnp.asarray(x)


def _assert_states(got, want, exact_counts):
    for task in want:
        for gs, ws in zip(got[task], want[task]):
            assert set(gs) == set(ws)
            for k in ws:
                g, w = gs[k].numpy(), np.asarray(ws[k])
                if exact_counts and k in COUNT_KEYS:
                    np.testing.assert_array_equal(g, w, err_msg=f"{task} {k}")
                else:
                    np.testing.assert_allclose(g, w, rtol=SUM_RTOL, err_msg=f"{task} {k}")


@pytest.mark.parametrize("kind", ["none", "array", "dict"])
def test_every_metric_matches_jax(kind):
    pm, jm = _pairs()
    ps = M.init_metrics(pm, "cpu")
    js = JM.init_metrics(jm)
    for seed in (0, 1):                     # two updates: the states accumulate
        y, p = _data(seed)
        w = _weights(kind, seed)
        ps = M.update_metrics(pm, ps, _to_torch(y), _to_torch(p), _to_torch(w))
        js = JM.update_metrics(jm, js, _to_jax(y), _to_jax(p), _to_jax(w))
    _assert_states(ps, js, exact_counts=kind == "none")
    got = M.compute_metrics(pm, ps)
    # compute on the port's own states, converted, so the check is compute's
    want = JM.compute_metrics(jm, {t: [{k: jnp.asarray(v.numpy()) for k, v in s.items()}
                                       for s in ss] for t, ss in ps.items()})
    for task in want:
        assert list(got[task]) == list(want[task])
        for name in want[task]:
            np.testing.assert_allclose(got[task][name].numpy(), np.asarray(want[task][name]),
                                       rtol=COMPUTE_RTOL, err_msg=f"{task} {name}")


@pytest.mark.parametrize("n", [200, 50, 11])
def test_auc_thresholds_are_the_jax_packages_bit_for_bit(n):
    want = np.asarray(inspect.getclosurevars(JM.auc(n).update).nonlocals["thresholds"])
    got = M.auc_thresholds(n)
    assert got.dtype == np.float32 and got.shape == want.shape == (n,)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_predictions_on_the_thresholds_count_as_jax_counts_them():
    thr = M.auc_thresholds(200)
    below = np.nextafter(thr, np.float32(-np.inf))
    above = np.nextafter(thr, np.float32(np.inf))
    p = np.concatenate([thr, below, above]).astype(np.float32)[:, None]
    y = (np.arange(p.shape[0]) % 3 == 0).astype(np.float32)[:, None]
    pm, jm = M.auc(), JM.auc()
    got = pm.update(pm.init("cpu"), torch.from_numpy(y), torch.from_numpy(p))
    want = jm.update(jm.init(), jnp.asarray(y), jnp.asarray(p))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_bin_accuracy_ties_take_the_first_index_as_jax():
    """Watch times halfway between two edges (argmin's tie) and rows with
    two equal maxima (argmax's tie), placed so that the count of correct
    rows depends on both tie rules: the first index wins in each."""
    edges = np.asarray(BIN_LIST, np.float32)
    wt = np.array([10.25, -18.75, 0.25, 55.75, 180.0, 10.0, -30.0, 300.0], np.float32)
    nearest = [int(np.argmin(np.abs(edges - w))) for w in wt]
    maxima = [(nearest[i], nearest[i] + 1) for i in range(4)]     # halfway: both edges
    maxima += [(398, 399), (nearest[5] - 3, nearest[5]), (0, 5), (100, 399)]
    assert nearest[:4] == [58, 0, 38, 149] and nearest[4:] == [398, 58, 0, 399]
    b = wt.shape[0]
    dist = np.random.default_rng(3).uniform(0, 1, (b, 400)).astype(np.float32)
    for i, (j, k) in enumerate(maxima):
        dist[i, [j, k]] = 5.0
    y = np.concatenate([np.zeros((b, 400), np.float32), wt[:, None]], 1)
    p = np.concatenate([dist, np.zeros((b, 1), np.float32)], 1)
    pm, jm = M.bin_accuracy(BIN_LIST), JM.bin_accuracy(JAX_BIN_LIST)
    got = pm.update(pm.init("cpu"), torch.from_numpy(y), torch.from_numpy(p))
    want = jm.update(jm.init(), jnp.asarray(y), jnp.asarray(p))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # correct where the first maximum is the first nearest edge
    assert got["correct"].item() == 6.0 and got["n"].item() == 8.0


def test_states_share_no_storage_and_update_is_functional():
    pm, jm = M.auc(), JM.auc()
    s0 = pm.init("cpu")
    ptrs = {k: v.data_ptr() for k, v in s0.items()}
    assert len(set(ptrs.values())) == 4
    y, p = _data(4)
    s1 = pm.update(s0, torch.from_numpy(y["a"]), torch.from_numpy(p["a"]))
    for v in s0.values():
        assert not v.any()                    # the input state is untouched
    y2, p2 = _data(5)
    s2 = pm.update(s1, torch.from_numpy(y2["a"]), torch.from_numpy(p2["a"]))
    j = jm.update(jm.init(), jnp.asarray(y["a"]), jnp.asarray(p["a"]))
    j = jm.update(j, jnp.asarray(y2["a"]), jnp.asarray(p2["a"]))
    for k in j:
        np.testing.assert_array_equal(s2[k].numpy(), np.asarray(j[k]), err_msg=k)
    assert not torch.equal(s2["tp"], s2["fp"]) and not torch.equal(s2["tn"], s2["fn"])


def test_ctr_tasks_share_metric_objects_but_not_states():
    bundle = create_model("ctr", cfg=synthetic_ctr_config(num_slots=8, num_bias=4),
                          bucket_size=256, device="cpu")
    mc, me = bundle.metrics[T_CLICK], bundle.metrics[T_EFFECT]
    assert all(a is b for a, b in zip(mc, me))
    states = M.init_metrics(bundle.metrics, bundle.device)
    ptrs = [t.data_ptr() for ss in states.values() for s in ss for t in s.values()]
    assert len(ptrs) == len(set(ptrs))
    y, p = _data(6)
    jm = {T_CLICK: [JM.binary_accuracy(), JM.auc(), JM.copc()]}
    jm[T_EFFECT] = jm[T_CLICK]
    ty = {T_CLICK: torch.from_numpy(y["a"]), T_EFFECT: torch.from_numpy(y["b"])}
    tp = {T_CLICK: torch.from_numpy(p["a"]), T_EFFECT: torch.from_numpy(p["b"])}
    states = M.update_metrics(bundle.metrics, states, ty, tp)
    want = JM.update_metrics(jm, JM.init_metrics(jm),
                             {T_CLICK: jnp.asarray(y["a"]), T_EFFECT: jnp.asarray(y["b"])},
                             {T_CLICK: jnp.asarray(p["a"]), T_EFFECT: jnp.asarray(p["b"])})
    _assert_states(states, want, exact_counts=False)
    assert not torch.equal(states[T_CLICK][1]["tp"], states[T_EFFECT][1]["tp"])


def test_a_state_on_another_device_raises():
    m = M.auc()
    state = m.init("meta")
    with pytest.raises(M.MetricDeviceError, match="meta"):
        m.update(state, torch.ones(4, 1), torch.ones(4, 1))
    pm, _ = _pairs()
    states = M.init_metrics(pm, "meta")
    y, p = _data(7)
    with pytest.raises(M.MetricDeviceError):
        M.update_metrics(pm, states, _to_torch(y), _to_torch(p))
