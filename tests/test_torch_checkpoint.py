"""The port's checkpoint: round trips of every model, named errors on a
target that differs, the mapping of a card's checkpoint onto the CPU, and
the continuation of a JAX checkpoint in step with the JAX package.

The cross-package check takes JAX autoint (SparseAdam, the tables in the
packed-state layout) and JAX staytime (AdaGrad): 2 JAX packed steps, an
orbax ``save_checkpoint`` / ``restore_checkpoint``, the restored state's
classic per-row view read as numpy and carried across by
``bridge.from_jax_numpy``, a port ``save_checkpoint`` /
``restore_checkpoint`` round trip, then 3 more steps in each package on the
same batches, dropout off on both sides.  Tolerances, as the train-step
tests: losses rtol 1e-5; weights and dense params atol 1e-5; moments and
g2sum rtol 1e-4, atol 1e-9; t and show exact (the staytime helper's rule
for the DIN scorer's ``b2``, a gradient of 0 in exact arithmetic, holds).
A round trip inside the port is bit for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch

from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train import restore_checkpoint as jax_restore_checkpoint
from recommendsystem_tpu.train import save_checkpoint as jax_save_checkpoint
from recommendsystem_tpu.train.step import make_train_step as jax_make_train_step
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.train import (create_train_state, make_predict_step,
                                             make_train_step, restore_checkpoint,
                                             save_checkpoint)
from recommendsystem_tpu_torch.train.checkpoint import CheckpointMismatchError, latest_step
from test_torch_autoint_train import LOSS_RTOL, NO_DROPOUT
from test_torch_autoint_train import _assert_states_match as assert_adam_states_match
from test_torch_eval import MODELS
from test_torch_staytime_serving import _bundles as staytime_bundles
from test_torch_staytime_train import _assert_states_match as assert_adagrad_states_match

torch.set_num_threads(1)
B = 16


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def assert_states_equal(a, b):
    """Every tensor bit for bit, the ints equal."""
    assert a.step == b.step and a.opt_state["count"] == b.opt_state["count"]
    la = dict(_leaves({"params": a.params, "mu": a.opt_state["mu"],
                       "nu": a.opt_state["nu"], "tables": a.tables}))
    lb = dict(_leaves({"params": b.params, "mu": b.opt_state["mu"],
                       "nu": b.opt_state["nu"], "tables": b.tables}))
    assert la.keys() == lb.keys()
    for k, v in la.items():
        assert torch.equal(v, lb[k]), k


@pytest.mark.parametrize("name", list(MODELS))
def test_round_trip_of_every_model(name, tmp_path):
    """Two steps, a save, a restore into a state of another seed: the
    restored state equals the saved one bit for bit and predicts the same
    outputs."""
    bundle = create_model(name, device="cpu", **MODELS[name][1])
    state = create_train_state(bundle, seed=3)
    batch, dense, labels, weight = synthetic_batch(bundle, B, seed=1)
    step = make_train_step(bundle)
    for i in range(2):
        state, _ = step(state, batch, labels, weight, dense, seed=i)
    path = save_checkpoint(str(tmp_path / "ck"), state)
    assert path == str(tmp_path / "ck" / "2") and os.listdir(path) == ["state.pt"]
    restored = restore_checkpoint(str(tmp_path / "ck"), create_train_state(bundle, seed=9))
    assert_states_equal(restored, state)
    predict = make_predict_step(bundle)
    want, got = predict(state, batch, dense), predict(restored, batch, dense)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _small_autoint(bucket=64):
    bundle = create_model("autoint", bucket_size=bucket, device="cpu")
    return bundle, create_train_state(bundle, seed=0)


def test_latest_step_and_replacing_a_step(tmp_path):
    bundle, state = _small_autoint()
    root = str(tmp_path / "ck")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(root, state)
    assert latest_step(root) is None
    for step in (2, 10, 9):
        save_checkpoint(root, state, step=step)
    assert latest_step(root) == 10
    assert sorted(os.listdir(root)) == ["10", "2", "9"]        # no temporary left
    # a step saved again replaces the old one whole
    state.params["logits.dense_0.bias"].fill_(7.0)
    save_checkpoint(root, state, step=10)
    got = restore_checkpoint(root, create_train_state(bundle, seed=1))
    assert float(got.params["logits.dense_0.bias"][0]) == 7.0 and got.step == 0
    older = restore_checkpoint(root, state, step=2)
    assert float(older.params["logits.dense_0.bias"][0]) != 7.0
    assert sorted(os.listdir(root)) == ["10", "2", "9"]


def _mismatch(state, what):
    """A copy of ``state``'s containers with one entry changed."""
    params = dict(state.params)
    tables = {k: dict(v) for k, v in state.tables.items()}
    opt = {**state.opt_state, "mu": dict(state.opt_state["mu"])}
    skey = sorted(tables)[0]
    if what == "shape":
        tables[skey]["w"] = torch.zeros(3, 8)
    elif what == "dtype":
        params["logits.dense_0.bias"] = params["logits.dense_0.bias"].double()
    elif what == "missing":
        params["extra.kernel"] = torch.zeros(2)
    elif what == "unexpected":
        del opt["mu"]["logits.dense_0.bias"]
    elif what == "type":
        opt["count"] = torch.zeros(())
    return type(state)(params=params, opt_state=opt, tables=tables, step=state.step)


@pytest.mark.parametrize("what,where", [
    ("shape", r"state\.tables\.\S+\.w: \(\d+, 8\) torch.float32 in the checkpoint, \(3, 8\)"),
    ("dtype", r"state\.params\.logits\.dense_0\.bias: .*float32 in the checkpoint, .*float64"),
    ("missing", r"state\.params\.extra\.kernel: in the target, not in the checkpoint"),
    ("unexpected", r"state\.opt_state\.mu\.logits\.dense_0\.bias: in the checkpoint, not in"),
    ("type", r"state\.opt_state\.count: int in the checkpoint, tensor in the target"),
])
def test_mismatched_target_raises_a_named_error(tmp_path, what, where):
    _, state = _small_autoint()
    save_checkpoint(str(tmp_path), state)
    with pytest.raises(CheckpointMismatchError, match=where) as err:
        restore_checkpoint(str(tmp_path), _mismatch(state, what))
    assert isinstance(err.value, ValueError)


def test_a_cards_checkpoint_maps_onto_the_target_device(tmp_path, monkeypatch):
    """A checkpoint whose storages are tagged ``cuda:0``, as one saved on
    the card is, restores onto the CPU target's device: the load maps every
    storage there (without the mapping, a machine with no card could not
    read it)."""
    bundle, state = _small_autoint()
    with monkeypatch.context() as m:
        m.setattr(torch.serialization, "location_tag", lambda storage: "cuda:0")
        save_checkpoint(str(tmp_path), state)
    raw = os.path.join(str(tmp_path), "0", "state.pt")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            torch.load(raw, weights_only=True)
    restored = restore_checkpoint(str(tmp_path), create_train_state(bundle, seed=5))
    assert all(t.device.type == "cpu" for _, t in _leaves(restored.tables))
    assert_states_equal(restored, state)


# -- continuing a JAX checkpoint ---------------------------------------------

def _autoint_pair():
    jb = jax_create_model("autoint", bucket_size=256, model_param=NO_DROPOUT)
    pb = create_model("autoint", bucket_size=256, model_param=NO_DROPOUT, device="cpu")
    return jb, pb


PAIRS = {"autoint": (_autoint_pair, assert_adam_states_match),
         "staytime": (lambda: staytime_bundles("cfg16_split"), assert_adagrad_states_match)}


@pytest.mark.parametrize("name", list(PAIRS))
def test_jax_checkpoint_continues_in_step_with_jax(name, tmp_path):
    make_pair, assert_match = PAIRS[name]
    jbundle, pbundle = make_pair()
    batches = [(jax_synthetic_batch(jbundle, B, seed=10 + i),
                synthetic_batch(pbundle, B, seed=10 + i)) for i in range(5)]
    jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(2), batches[0][0][0])
    jstep = jax_make_train_step(jbundle, donate=False, sparse_update="packed")
    for i in range(2):
        jb, jd, jl, jw = batches[i][0]
        jstate, _ = jstep(jstate, jb, jl, jw, jd, jax.random.PRNGKey(i))
    jax_save_checkpoint(str(tmp_path / "jax"), jstate)
    jstate = jax_restore_checkpoint(str(tmp_path / "jax"), jstate)
    assert int(jstate.step) == 2
    pstate = bridge.from_jax_numpy(
        pbundle, jax.tree.map(np.asarray, jstate.params),
        jax.device_get(jbundle.embedding.classic_state(jstate.tables)),
        step=int(jstate.step), opt_state=jax.tree.map(np.asarray, jstate.opt_state))
    save_checkpoint(str(tmp_path / "port"), pstate)
    pstate = restore_checkpoint(str(tmp_path / "port"), create_train_state(pbundle, seed=1))
    assert pstate.step == 2 and pstate.opt_state["count"] == 2
    assert_match(jbundle, jstate, pstate)
    pstep = make_train_step(pbundle)
    for i in range(2, 5):
        (jb, jd, jl, jw), (pb, pd, pl, pw) = batches[i]
        jstate, jinfo = jstep(jstate, jb, jl, jw, jd, jax.random.PRNGKey(i))
        pstate, pinfo = pstep(pstate, pb, pl, pw, pd, seed=i)
        for key, want in jax.device_get(jinfo).items():
            np.testing.assert_allclose(float(pinfo[key]), float(want), rtol=LOSS_RTOL,
                                       err_msg=f"{name} step {i} {key}")
    assert pstate.step == int(jstate.step) == 5
    assert_match(jbundle, jstate, pstate)
