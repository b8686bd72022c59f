"""The port's eval path for all six models against the JAX package, from
state bridged with ``bridge.from_jax_numpy``: the bundles' metric lists,
``make_eval_step`` (outputs against the JAX eval step's; metric states
against the JAX metrics applied to the port's own outputs, so that a
prediction on an AUC threshold cannot flip a count between two right
answers), ``evaluate``, ``predict``, ``dump_predict`` with ``need_y`` (the
dumped scores parsed and held to the JAX predict step's), ``evaluate_gauc``
and ``evaluate_gauc_streaming`` (against the JAX ``group_auc`` and
streaming GAUCs applied to the port's predictions).

Configurations (small): autoint over 256-id buckets; ctr
``synthetic_ctr_config(num_slots=8, num_bias=4)``; multi_head 6 slots;
finish 12 slots (4 bias); rough_rank 4 user and 3 item slots with the flag
4575; staytime the 16-slot config of ``tests/test_torch_staytime_serving.py``
with experts (16, 8).  B 32, two batches (seeds 21 and 22).  Tolerances:
outputs rtol 1e-5, atol 2e-6 (float32 products summed in another order);
states: counts exact with unit weights, weighted sums rtol 1e-5;
``evaluate``'s values and the GAUCs rtol 1e-6; dumped scores as the outputs
(their 6 printed digits are within that)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.core.config import synthetic_ctr_config as jax_synthetic_ctr_config
from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.models.staytime import StaytimeConfig as JaxStaytimeConfig
from recommendsystem_tpu.search.gauc import group_auc as jax_group_auc
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train import metrics as JM
from recommendsystem_tpu.train import streaming_gauc as JSG
from recommendsystem_tpu.train.step import make_eval_step as jax_make_eval_step
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.core.config import synthetic_ctr_config
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.staytime import (T_LONG, T_SHORT, T_STAY,
                                                       StaytimeConfig)
from recommendsystem_tpu_torch.train import (StreamingGauc, StreamingSpearmanGauc,
                                             dump_predict, evaluate, evaluate_gauc,
                                             evaluate_gauc_streaming, make_eval_step,
                                             make_gauc_eval_step, predict)
from recommendsystem_tpu_torch.train import metrics as M

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)
SUM_RTOL = 1e-5
VALUE_RTOL = 1e-6
B = 32
SEEDS = (21, 22)
N_USERS = 6
COUNT_KEYS = {"correct", "total", "tp", "fp", "tn", "fn", "label", "n"}

_S16 = tuple(str(9000 + i) for i in range(16))
_STAY16 = dict(
    slots=_S16, seq_slots=(_S16[8], _S16[9], _S16[10]), user_slots=_S16[0:4],
    item_slots=_S16[4:8],
    bias_slots=(_S16[0], _S16[2], _S16[4], _S16[6], _S16[11], _S16[12]),
    seq_query=((_S16[8], _S16[4]), (_S16[9], _S16[5]), (_S16[10], _S16[6])),
    seq_max_len=5, bucket_size=64)
_FINISH = tuple(str(3000 + i) for i in range(12))
MODELS = {
    "autoint": (dict(bucket_size=256), dict(bucket_size=256)),
    "ctr": (dict(cfg=jax_synthetic_ctr_config(num_slots=8, num_bias=4), bucket_size=256),
            dict(cfg=synthetic_ctr_config(num_slots=8, num_bias=4), bucket_size=256)),
    "multi_head": (dict(slots=tuple(str(2000 + i) for i in (5, 0, 3, 1, 4, 2)),
                        bucket_size=256),) * 2,
    "finish": (dict(slots=_FINISH, bias_slots=_FINISH[:4], bucket_size=256),) * 2,
    "rough_rank": (dict(user_slots=tuple(str(s) for s in range(1560, 1564)),
                        item_slots=tuple(str(s) for s in range(1591, 1594)),
                        bucket_size=256),) * 2,
    "staytime": (dict(cfg=JaxStaytimeConfig(**_STAY16), deep_hidden_units=(16, 8)),
                 dict(cfg=StaytimeConfig(**_STAY16), deep_hidden_units=(16, 8))),
}
_PAIRS = {}


def _pair(name):
    """(JAX bundle, JAX state, port bundle, port state)."""
    if name not in _PAIRS:
        jkw, pkw = MODELS[name]
        jbundle = jax_create_model(name, **jkw)
        pbundle = create_model(name, device="cpu", **pkw)
        jb, jd, _, _ = jax_synthetic_batch(jbundle, 8, seed=0)
        jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(4), jb, dense_inputs=jd)
        pstate = bridge.from_jax_numpy(
            pbundle, jax.tree.map(np.asarray, jstate.params),
            {k: np.asarray(v) for k, v in jbundle.embedding.weights(jstate.tables).items()})
        _PAIRS[name] = (jbundle, jstate, pbundle, pstate)
    return _PAIRS[name]


def _weight(name, pbundle, weight, seed):
    """multi_head takes a weight per task; the others their batch's."""
    if name != "multi_head":
        return weight
    rng = np.random.default_rng(seed + 100)
    return {t: torch.from_numpy(rng.uniform(0.5, 2.0, (B, 1)).astype(np.float32))
            for t in pbundle.metrics}


def _np(x):
    return {k: v.numpy() for k, v in x.items()} if isinstance(x, dict) else x.numpy()


def _jnp(x):
    if x is None:
        return None
    return {k: jnp.asarray(v) for k, v in x.items()} if isinstance(x, dict) else jnp.asarray(x)


def _unit(weight):
    ws = weight.values() if isinstance(weight, dict) else [weight]
    return all(w is None or bool((w == 1).all()) for w in ws)


def _eval_batches(name):
    """Per seed: the JAX batch and eval outputs, and the port's batch,
    weight, eval step outputs and metric states after that batch."""
    jbundle, jstate, pbundle, pstate = _pair(name)
    jstep, pstep = jax_make_eval_step(jbundle), make_eval_step(pbundle)
    states = M.init_metrics(pbundle.metrics, pbundle.device)
    out = []
    for seed in SEEDS:
        jb, jd, jl, jw = jax_synthetic_batch(jbundle, B, seed=seed)
        pb, pd, pl, pw = synthetic_batch(pbundle, B, seed=seed)
        w = _weight(name, pbundle, pw, seed)
        _, jouts = jstep(jstate, jb, jl, _jnp(_np(w)), jd, JM.init_metrics(jbundle.metrics))
        states, pouts = pstep(pstate, pb, pl, w, pd, states)
        out.append(dict(jouts=jouts, pb=pb, pd=pd, pl=pl, w=w, pouts=pouts, states=states))
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_bundles_carry_the_jax_metric_lists(name):
    jbundle, _, pbundle, _ = _pair(name)
    got = {t: [m.name for m in ms] for t, ms in pbundle.metrics.items()}
    assert got == {t: [m.name for m in ms] for t, ms in jbundle.metrics.items()}
    assert all(isinstance(m, M.Metric) for ms in pbundle.metrics.values() for m in ms)


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_step_outputs_and_metric_states_match_jax(name):
    jbundle, _, pbundle, _ = _pair(name)
    runs = _eval_batches(name)
    jstates = JM.init_metrics(jbundle.metrics)
    for r in runs:
        assert set(r["pouts"]) == set(r["jouts"])
        for k, v in r["jouts"].items():
            np.testing.assert_allclose(r["pouts"][k].numpy(), np.asarray(v), err_msg=k, **TOL)
        # the JAX metrics on the port's own full outputs
        jstates = JM.update_metrics(
            jbundle.metrics, jstates, {t: jnp.asarray(r["pl"][t].numpy()) for t in jbundle.metrics},
            {t: jnp.asarray(r["pouts"][t].numpy()) for t in jbundle.metrics}, _jnp(_np(r["w"])))
    exact = all(_unit(r["w"]) for r in runs)
    for task, ws in jstates.items():
        for m, gs, s in zip(jbundle.metrics[task], runs[-1]["states"][task], ws):
            for k in s:
                g, w = gs[k].numpy(), np.asarray(s[k])
                if exact and k in COUNT_KEYS:
                    np.testing.assert_array_equal(g, w, err_msg=f"{task} {m.name} {k}")
                else:
                    np.testing.assert_allclose(g, w, rtol=SUM_RTOL,
                                               err_msg=f"{task} {m.name} {k}")
    if name == "staytime":
        # the stay head's metrics read the train output, not predict_view's
        assert runs[0]["pouts"][T_STAY].shape == (B, 401)


@pytest.mark.parametrize("name", list(MODELS))
def test_evaluate_matches_the_jax_metrics_on_the_port_outputs(name):
    jbundle, _, pbundle, pstate = _pair(name)
    runs = _eval_batches(name)
    got = evaluate(pbundle, [(r["pb"], r["pd"], r["pl"], r["w"]) for r in runs], pstate)
    jstates = JM.init_metrics(jbundle.metrics)
    for r in runs:
        jstates = JM.update_metrics(
            jbundle.metrics, jstates, {t: jnp.asarray(r["pl"][t].numpy()) for t in jbundle.metrics},
            {t: jnp.asarray(r["pouts"][t].numpy()) for t in jbundle.metrics}, _jnp(_np(r["w"])))
    want = jax.device_get(JM.compute_metrics(jbundle.metrics, jstates))
    assert set(got) == set(want)
    for task in want:
        assert set(got[task]) == set(want[task])
        for k, v in want[task].items():
            assert isinstance(got[task][k], float)
            np.testing.assert_allclose(got[task][k], float(v), rtol=VALUE_RTOL,
                                       err_msg=f"{task} {k}")
    if name in ("autoint", "ctr", "multi_head", "rough_rank"):
        for task in got:
            assert 0.0 <= got[task]["auc"] <= 1.0 and 0.0 <= got[task]["acc"] <= 1.0


def _dataset(name, with_users=True):
    _, _, pbundle, _ = _pair(name)
    rng = np.random.default_rng(7)
    for seed in SEEDS:
        pb, pd, pl, pw = synthetic_batch(pbundle, B, seed=seed)
        extras = {"user_id": rng.integers(0, N_USERS, B),
                  "example_id": torch.arange(B) + 1000 * seed}
        yield (pb, pd, pl, pw, extras) if with_users else (pb, pd, pl, pw)


@pytest.mark.parametrize("name", list(MODELS))
def test_predict_and_dump_predict_match_jax(name, tmp_path):
    jbundle, _, pbundle, pstate = _pair(name)
    runs = _eval_batches(name)
    want = [jax.device_get(jbundle.predict_view(r["jouts"])) for r in runs]
    items = list(_dataset(name))
    for (ids, outs), w, item in zip(predict(pbundle, items, pstate, example_id_key="example_id"),
                                    want, items):
        np.testing.assert_array_equal(ids, item[4]["example_id"].numpy())
        assert set(outs) == set(w)
        for k in w:
            np.testing.assert_allclose(outs[k], np.asarray(w[k]), err_msg=k, **TOL)
    path = tmp_path / "dump.tsv"
    n = dump_predict(pbundle, iter(items), pstate, str(path), need_y=True)
    assert n == B * len(SEEDS)
    rows = [line.split("\t") for line in path.read_text().splitlines()]
    tasks = sorted(want[0])
    labelled = [t for t in tasks if t in items[0][2]]
    assert len(rows) == n and all(len(r) == 1 + len(tasks) + len(labelled) for r in rows)
    ids = np.array([int(r[0]) for r in rows])
    np.testing.assert_array_equal(ids, np.concatenate([it[4]["example_id"].numpy()
                                                       for it in items]))
    for j, t in enumerate(tasks):
        got = np.array([float(r[1 + j]) for r in rows])
        ref = np.concatenate([np.asarray(w[t]).reshape(B, -1)[:, 0] for w in want])
        np.testing.assert_allclose(got, ref, err_msg=t, **TOL)
    for j, t in enumerate(labelled):
        got = np.array([float(r[1 + len(tasks) + j]) for r in rows])
        ref = np.concatenate([it[2][t].numpy().reshape(B, -1)[:, -1] for it in items])
        np.testing.assert_allclose(got, ref, rtol=5e-6, err_msg=t)


def _gaucs(name):
    """The port's streaming GAUC metric per task, and the JAX one."""
    if name == "staytime":
        kw = dict(pred_lo=-20.0, pred_hi=181.0, label_lo=0.0, label_hi=161.0)
        return ({T_STAY: StreamingSpearmanGauc(**kw), T_SHORT: StreamingGauc(num_bins=512),
                 T_LONG: StreamingGauc(num_bins=512)},
                {T_STAY: JSG.StreamingSpearmanGauc(**kw),
                 T_SHORT: JSG.StreamingGauc(num_bins=512),
                 T_LONG: JSG.StreamingGauc(num_bins=512)})
    return StreamingGauc(num_bins=512), JSG.StreamingGauc(num_bins=512)


@pytest.mark.parametrize("name", list(MODELS))
def test_gauc_evaluations_match_jax_on_the_port_predictions(name):
    jbundle, _, pbundle, pstate = _pair(name)
    tasks = tuple(jbundle.metrics)
    items = list(_dataset(name))
    preds = {t: [] for t in tasks}
    for (_, outs), item in zip(predict(pbundle, items, pstate), items):
        for t in tasks:
            preds[t].append(outs[t].reshape(B, -1)[:, -1])
    users = np.concatenate([it[4]["user_id"] for it in items])
    labels = {t: np.concatenate([it[2][t].numpy().reshape(B, -1)[:, -1] for it in items])
              for t in tasks}
    spearman = (T_STAY,) if name == "staytime" else ()

    offline = evaluate_gauc(pbundle, iter(items), pstate, spearman_tasks=spearman)
    assert set(offline) == set(tasks)
    for t in tasks:
        total, n = jax_group_auc(labels[t], np.concatenate(preds[t]), users,
                                 is_spearman=t in spearman)
        np.testing.assert_allclose(offline[t], total / n if n else 0.0, rtol=VALUE_RTOL)

    pg, jg = _gaucs(name)
    streaming = evaluate_gauc_streaming(pbundle, iter(items), pstate, gauc=pg)
    assert set(streaming) == set(tasks)
    for t in tasks:
        m = jg[t] if isinstance(jg, dict) else jg
        s = m.init()
        for i, it in enumerate(items):
            s = m.update(s, jnp.asarray(labels[t][i * B:(i + 1) * B]),
                         jnp.asarray(preds[t][i]), jnp.asarray(it[4]["user_id"]))
        np.testing.assert_allclose(streaming[t], float(m.compute(s)), rtol=VALUE_RTOL,
                                   err_msg=t)
        assert isinstance(streaming[t], float)


def test_gauc_eval_step_keeps_its_states_additive():
    _, _, pbundle, pstate = _pair("autoint")
    g = StreamingGauc(num_buckets=64, num_bins=128)
    step = make_gauc_eval_step(pbundle, g)
    items = list(_dataset("autoint"))
    t = next(iter(pbundle.metrics))
    s = {t: g.init(pbundle.device)}
    for it in items:
        s = step(pstate, it[0], it[1], it[2], torch.from_numpy(it[4]["user_id"]), s)
    parts = [step(pstate, it[0], it[1], it[2], torch.from_numpy(it[4]["user_id"]),
                  {t: g.init(pbundle.device)})[t] for it in items]
    for k in s[t]:
        np.testing.assert_allclose(s[t][k].numpy(), (parts[0][k] + parts[1][k]).numpy())
    with pytest.raises(KeyError, match="missing task"):
        evaluate_gauc_streaming(pbundle, [(it[0], it[1], {}, it[3], it[4]) for it in items],
                                pstate)
    assert evaluate_gauc_streaming(pbundle, [], pstate) == {}
