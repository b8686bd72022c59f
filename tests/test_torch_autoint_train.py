"""The port's packed train step against the JAX package's.

Both start from the same state, carried across by ``bridge.from_jax_numpy``
(dense params, optax's Adam state and the tables' classic per-row view),
and take 3 steps on the same batch with attention dropout off on both
sides: on the CPU the JAX layer draws flax dropout, whose stream no port
can match (``ROADMAP.md``).  Tolerances, as ``tests/test_packed.py`` holds
the JAX package's own update paths to each other: losses rtol 1e-5; table
weights and dense params atol 1e-5 (float32 products summed in another
order, and an Adam step of ~lr = 5e-5 whose size m_hat / sqrt(v_hat) is
sensitive to tiny gradients); moments rtol 1e-4 and atol 1e-9 (the same
gradients, before Adam's division); t and show exact (sums of 1.0).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.embedding import EmbeddingFeatures as JaxEngine
from recommendsystem_tpu.embedding import SparseAdam as JaxSparseAdam
from recommendsystem_tpu.embedding import category_column as jcat
from recommendsystem_tpu.embedding import embedding_column as jemb
from recommendsystem_tpu.embedding import packed as jpk
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train.step import make_train_step as jax_make_train_step
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.embedding import (EmbeddingFeatures,
                                                 category_column,
                                                 embedding_column, packed)
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.autoint import TASK, clip
from recommendsystem_tpu_torch.train import (create_train_state,
                                             make_scan_train_step,
                                             make_train_step)

torch.set_num_threads(1)
LOSS_RTOL = 1e-5
ATOL = 1e-5
MOMENT_TOL = dict(rtol=1e-4, atol=1e-9)
NO_DROPOUT = {"interact": {"layer_num": 1, "unit_num": 8, "head_num": 2,
                           "use_dropout": False, "dropout_rate": 0.2,
                           "use_res": True}}


def _bridged(bucket=256, batch=32, seed=3, ids_per_feature=5):
    jbundle = jax_create_model("autoint", bucket_size=bucket,
                               model_param=NO_DROPOUT)
    pbundle = create_model("autoint", bucket_size=bucket,
                           model_param=NO_DROPOUT, device="cpu")
    jb, _, jl, jw = jax_synthetic_batch(jbundle, batch, seed=seed,
                                        ids_per_feature=ids_per_feature)
    pb, _, pl, pw = synthetic_batch(pbundle, batch, seed=seed,
                                    ids_per_feature=ids_per_feature)
    jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(0), jb)
    pstate = bridge.from_jax_numpy(
        pbundle, jax.tree.map(np.asarray, jstate.params),
        jax.device_get(jbundle.embedding.classic_state(jstate.tables)),
        opt_state=jax.tree.map(np.asarray, jstate.opt_state))
    return (jbundle, jstate, jb, jl, jw), (pbundle, pstate, pb, pl, pw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_states_match(jbundle, jstate, pstate):
    jc = jax.device_get(jbundle.embedding.classic_state(jstate.tables))
    pc = pstate.tables
    assert set(jc) == set(pc)
    for skey in jc:
        np.testing.assert_allclose(pc[skey]["w"].numpy(), jc[skey]["w"],
                                   rtol=0, atol=ATOL, err_msg=skey)
        for name in ("m", "v"):
            np.testing.assert_allclose(pc[skey]["opt"][name].numpy(),
                                       jc[skey]["opt"][name], **MOMENT_TOL,
                                       err_msg=f"{skey} {name}")
        np.testing.assert_array_equal(pc[skey]["opt"]["t"].numpy(),
                                      jc[skey]["opt"]["t"], err_msg=skey)
        np.testing.assert_array_equal(pc[skey]["show"].numpy(), jc[skey]["show"],
                                      err_msg=skey)
    jp = _flat(jax.device_get(jstate.params))
    assert set(jp) == set(pstate.params)
    for k, v in jp.items():
        np.testing.assert_allclose(pstate.params[k].numpy(), v, rtol=0,
                                   atol=ATOL, err_msg=k)
    assert pstate.opt_state["count"] == int(jstate.opt_state[0].count)


@pytest.mark.parametrize("ids_per_feature", [5, 1])
def test_three_steps_match_jax_packed_steps(ids_per_feature):
    (jbundle, jstate, jb, jl, jw), (pbundle, pstate, pb, pl, pw) = _bridged(
        ids_per_feature=ids_per_feature)
    jstep = jax_make_train_step(jbundle, donate=False, sparse_update="packed")
    pstep = make_train_step(pbundle)
    reset_launch_counts()
    for i in range(3):
        jstate, jinfo = jstep(jstate, jb, jl, jw, None, jax.random.PRNGKey(i))
        pstate, pinfo = pstep(pstate, pb, pl, pw, None, seed=i)
        np.testing.assert_allclose(float(pinfo["loss"]), float(jinfo["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(pinfo[f"loss/{TASK}"]),
                                   float(jinfo[f"loss/{TASK}"]), rtol=LOSS_RTOL)
    assert pstate.step == 3
    _assert_states_match(jbundle, jstate, pstate)
    # the CPU runs every kernel as its plain version
    assert set(launch_counts().values()) == {0}


def test_live_counts_drive_t_and_show():
    """After k steps on one batch, t counts the steps in which a row was
    live and show the total of its occurrences: k and k x row_counts."""
    _, (pbundle, pstate, pb, pl, pw) = _bridged()
    counts = pbundle.embedding.row_counts(pb)
    step = make_train_step(pbundle)
    for i in range(2):
        pstate, _ = step(pstate, pb, pl, pw, seed=i)
    for skey, tstate in pstate.tables.items():
        c = counts[skey]
        torch.testing.assert_close(tstate["show"], 2 * c, rtol=0, atol=0)
        torch.testing.assert_close(tstate["opt"]["t"], 2 * (c > 0).float(),
                                   rtol=0, atol=0)
        assert not pbundle.embedding.accumulator(skey, "cpu").any()


def test_scan_driver_equals_single_steps():
    _, (pbundle, s1, pb, pl, pw) = _bridged()
    _, (_, s2, _, _, _) = _bridged()
    step = make_train_step(pbundle)
    losses = []
    for i in range(3):
        s1, info = step(s1, pb, pl, pw, None, seed=10 + i)
        losses.append(float(info["loss"]))
    s2, infos = make_scan_train_step(pbundle)(s2, [pb] * 3, [pl] * 3, [pw] * 3,
                                              None, [10, 11, 12])
    np.testing.assert_array_equal(infos["loss"].numpy(), np.float32(losses))
    for skey in s1.tables:
        torch.testing.assert_close(s2.tables[skey]["w"], s1.tables[skey]["w"],
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="one of each"):
        make_scan_train_step(pbundle)(s2, [pb] * 2, [pl] * 2, None, None, [1])


def test_dropout_is_drawn_from_the_step_seed():
    """With the layer's dropout on (rate 0.2), the same seed gives the same
    loss and another seed another one."""
    pbundle = create_model("autoint", bucket_size=64, device="cpu")
    pb, _, pl, pw = synthetic_batch(pbundle, 16, seed=1)
    losses = []
    for seed in (4, 4, 5):
        state = create_train_state(pbundle, seed=0)
        _, info = make_train_step(pbundle)(state, pb, pl, pw, seed=seed)
        losses.append(float(info["loss"]))
    assert losses[0] == losses[1] != losses[2]


def _jax_engine(max_group_bytes):
    slots = [str(1000 + i) for i in range(24)]
    jeng = JaxEngine([jemb(jcat(s, 256), 8, combiner="mean", name=s) for s in slots],
                     JaxSparseAdam(), group_tables=True,
                     max_group_bytes=max_group_bytes)
    peng = EmbeddingFeatures([embedding_column(category_column(s, 256), 8,
                                               combiner="mean", name=s)
                              for s in slots],
                             group_tables=True, max_group_bytes=max_group_bytes)
    assert peng.storage == jeng.storage and peng.table_map == jeng.table_map
    return jeng, peng


@pytest.mark.parametrize("ids_per_feature", [5, 1])
@pytest.mark.parametrize("max_group_bytes", [10 << 20, 1])
def test_apply_gradients_packed_matches_jax(max_group_bytes, ids_per_feature):
    """Stage 3 alone on random activation grads.  10 MB groups all 24
    tables into one storage (24 columns unfold into one accumulator); 1
    byte gives every table its own storage, as at full width.  The JAX
    state starts from non-zero moments and counters (classic view packed
    by ``pack_state_entry``)."""
    jeng, peng = _jax_engine(max_group_bytes)
    rng = np.random.default_rng(max_group_bytes % 97 + ids_per_feature)
    classic = {}
    for skey, (rows, d) in peng.storage.items():
        classic[skey] = {
            "w": rng.standard_normal((rows, d)).astype(np.float32) / 3,
            "opt": {"m": rng.standard_normal((rows, d)).astype(np.float32) * 1e-3,
                    "v": rng.uniform(0, 1e-5, (rows, d)).astype(np.float32),
                    "t": rng.integers(0, 4, (rows, 1)).astype(np.float32)},
            "show": rng.integers(0, 9, (rows, 1)).astype(np.float32)}
    jstate = {k: jpk.pack_state_entry(jax.tree.map(jnp.asarray, v), 8)
              for k, v in classic.items()}
    pstate = {k: {"w": torch.tensor(v["w"]),
                  "opt": {n: torch.tensor(x) for n, x in v["opt"].items()},
                  "show": torch.tensor(v["show"])} for k, v in classic.items()}
    jbundle = jax_create_model("autoint", bucket_size=256)
    pbundle = create_model("autoint", bucket_size=256, device="cpu")
    jb, _, _, _ = jax_synthetic_batch(jbundle, 24, seed=7,
                                      ids_per_feature=ids_per_feature)
    pb, _, _, _ = synthetic_batch(pbundle, 24, seed=7,
                                  ids_per_feature=ids_per_feature)
    jplans = jpk.plan_segments(jeng, jb)
    pplans = packed.plan_segments(peng, pb)
    jctx = jpk.gather_fold(jeng, jstate, jb, jplans)
    pctx = packed.gather_fold(peng, pstate, pb, pplans)
    g_np = {skey: [rng.standard_normal(a.shape).astype(np.float32) * 1e-3
                   for a in pctx[skey]["acts"]] for skey in pplans}
    jnew = jpk.apply_gradients_packed(jeng, jstate, {k: [jnp.asarray(g) for g in v]
                                                     for k, v in g_np.items()},
                                      jplans, jctx, jb)
    pnew = packed.apply_gradients_packed(peng, pstate, {k: [torch.tensor(g) for g in v]
                                                        for k, v in g_np.items()},
                                         pplans, pctx, pb)
    assert pnew is pstate                      # updated in place
    for skey in classic:
        want = jax.device_get(jpk.unpack_state_entry(jnew[skey], 8))
        got = pnew[skey]
        np.testing.assert_allclose(got["w"].numpy(), want["w"], rtol=0, atol=ATOL)
        for name in ("m", "v"):
            np.testing.assert_allclose(got["opt"][name].numpy(), want["opt"][name],
                                       **MOMENT_TOL)
        np.testing.assert_array_equal(got["opt"]["t"].numpy(), want["opt"]["t"])
        np.testing.assert_array_equal(got["show"].numpy(), want["show"])
        # rows no entry touched are bit-identical
        untouched = want["show"][:, 0] == classic[skey]["show"][:, 0]
        np.testing.assert_array_equal(got["w"].numpy()[untouched],
                                      classic[skey]["w"][untouched])


def test_clip_tie_passes_half_the_gradient_as_jax():
    """At a value exactly on a bound, jnp.clip passes half the gradient;
    the port's clip does the same (torch.clamp would pass all of it)."""
    for x in (1.0, 1e-6, 0.5):
        want = float(jax.grad(lambda v: jnp.clip(v, 1e-6, 1.0))(jnp.float32(x)))
        t = torch.tensor(np.float32(x), requires_grad=True)
        clip(t).backward()
        assert float(t.grad) == want, x
    assert want == 1.0 and float(jax.grad(
        lambda v: jnp.clip(v, 1e-6, 1.0))(jnp.float32(1.0))) == 0.5


def test_saturated_sigmoid_step_matches_jax():
    """A logits bias of 40 saturates the float32 sigmoid to exactly 1.0, so
    every output sits on the clip's upper bound: the step's loss and
    updates still equal the JAX package's."""
    (jbundle, jstate, jb, jl, jw), (pbundle, pstate, pb, pl, pw) = _bridged()
    jparams = jax.tree.map(np.asarray, jstate.params)
    jparams["logits"]["dense_0"]["bias"] = np.full((1,), 40.0, np.float32)
    jstate = dataclasses.replace(jstate, params=jax.tree.map(jnp.asarray, jparams))
    pstate.params["logits.dense_0.bias"].fill_(40.0)
    jstep = jax_make_train_step(jbundle, donate=False, sparse_update="packed")
    jstate, jinfo = jstep(jstate, jb, jl, jw, None, jax.random.PRNGKey(0))
    pstate, pinfo = make_train_step(pbundle)(pstate, pb, pl, pw, seed=0)
    assert np.isfinite(float(pinfo["loss"]))
    np.testing.assert_allclose(float(pinfo["loss"]), float(jinfo["loss"]),
                               rtol=LOSS_RTOL)
    _assert_states_match(jbundle, jstate, pstate)


def test_bridge_carries_the_whole_state():
    (jbundle, jstate, *_), (pbundle, pstate, *_) = _bridged()
    _assert_states_match(jbundle, jstate, pstate)
    fresh = bridge.from_jax_numpy(
        pbundle, jax.tree.map(np.asarray, jstate.params),
        {k: np.asarray(v) for k, v in jbundle.embedding.weights(jstate.tables).items()})
    assert fresh.opt_state["count"] == 0
    for tstate in fresh.tables.values():
        assert not tstate["opt"]["t"].any() and not tstate["show"].any()
    with pytest.raises(ValueError, match="Adam"):
        bridge.from_jax_numpy(pbundle, jax.tree.map(np.asarray, jstate.params),
                              jax.device_get(jbundle.embedding.classic_state(
                                  jstate.tables)), opt_state=(1, 2))


def test_step_makes_one_grouped_lazy_adam_call(monkeypatch):
    """Every storage the step touched goes through one grouped K8 call a
    step, after all the unfold-scatters."""
    pbundle = create_model("autoint", bucket_size=64, device="cpu")
    pb, _, pl, pw = synthetic_batch(pbundle, 16, seed=2)
    calls = []
    real = packed.sparse_adam_update_group

    def spy(opt, tstates, accs):
        tstates, accs = list(tstates), list(accs)
        calls.append(len(tstates))
        assert all(a.any() for a in accs)       # filled before the pass
        return real(opt, tstates, accs)

    monkeypatch.setattr(packed, "sparse_adam_update_group", spy)
    state = create_train_state(pbundle, seed=0)
    step = make_train_step(pbundle)
    for i in range(2):
        state, _ = step(state, pb, pl, pw, seed=i)
    assert calls == [len(pbundle.embedding.storage)] * 2
    for skey in pbundle.embedding.storage:
        assert not pbundle.embedding.accumulator(skey, "cpu").any()
