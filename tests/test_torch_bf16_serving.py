"""bf16 tables on the port's serving and eval paths, and what carries bf16
state: the predict and eval steps of staytime (``table_dtype="auto"``) and
autoint (bf16 tables and moments) against the JAX package's from one
bridged state; the scoring service; the bridge with bf16 arrays; a bf16
checkpoint's round trip; the server's and the factories' dtype flags.

Lookups widen the same bf16 values to float32 in both packages, so the
outputs keep the float32 tolerances of the other serving tests: rtol 1e-5,
atol 2e-6 (float32 products summed in another order), and rtol 1e-5 for
staytime's expected value (a sum of 400 products)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.models.staytime import StaytimeConfig as JaxStaytimeConfig
from recommendsystem_tpu.serving import ScoringService as JaxScoringService
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train import metrics as JM
from recommendsystem_tpu.train.step import make_eval_step as jax_make_eval_step
from recommendsystem_tpu.train.step import make_predict_step as jax_make_predict_step
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.models import MODEL_REGISTRY, create_model
from recommendsystem_tpu_torch.models.staytime import T_STAY, StaytimeConfig
from recommendsystem_tpu_torch.serving import ScoringService
from recommendsystem_tpu_torch.serving import server as port_server
from recommendsystem_tpu_torch.train import (create_train_state, make_eval_step,
                                             make_predict_step, make_train_step,
                                             restore_checkpoint, save_checkpoint)
from recommendsystem_tpu_torch.train.checkpoint import CheckpointMismatchError
from recommendsystem_tpu_torch.train import metrics as M
from test_torch_staytime_serving import CFG16, HIDDEN, SMALL, _raw_rows

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)
EV_TOL = dict(rtol=1e-5)
B = 32


def _pair(name):
    """(JAX bundle, JAX state, port bundle, port state) over bf16 tables:
    staytime ``"auto"`` (16 slots), autoint bf16 tables and moments."""
    if name == "staytime":
        jbundle = jax_create_model("staytime", cfg=JaxStaytimeConfig(**CFG16),
                                   deep_hidden_units=HIDDEN, table_dtype="auto")
        pbundle = create_model("staytime", cfg=StaytimeConfig(**CFG16), deep_hidden_units=HIDDEN,
                               table_dtype="auto", device="cpu")
    else:
        jbundle = jax_create_model("autoint", bucket_size=256, table_dtype=jnp.bfloat16,
                                   opt_state_dtype=jnp.bfloat16)
        pbundle = create_model("autoint", bucket_size=256, table_dtype=torch.bfloat16,
                               opt_state_dtype=torch.bfloat16, device="cpu")
    jb = jax_synthetic_batch(jbundle, 8, seed=0)[0]
    jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(1), jb)
    classic = jax.device_get(jbundle.embedding.classic_state(jstate.tables))
    pstate = bridge.from_jax_numpy(pbundle, jax.tree.map(np.asarray, jstate.params), classic)
    return jbundle, jstate, pbundle, pstate


def _assert_outputs(got, want, what):
    assert set(got) == set(want), what
    for task in want:
        tol = EV_TOL if task.startswith(T_STAY) else TOL
        np.testing.assert_allclose(got[task].numpy(), np.asarray(want[task]), **tol,
                                   err_msg=f"{what} {task}")


@pytest.mark.parametrize("name", ["staytime", "autoint"])
@pytest.mark.parametrize("ipf", [5, 1])
def test_bf16_predict_and_eval_steps_match_jax(name, ipf):
    jbundle, jstate, pbundle, pstate = _pair(name)
    for t in pstate.tables.values():
        assert t["w"].dtype == torch.bfloat16
    jb, jd, jl, jw = jax_synthetic_batch(jbundle, B, seed=4, ids_per_feature=ipf)
    pb, pd, pl, pw = synthetic_batch(pbundle, B, seed=4, ids_per_feature=ipf)
    _assert_outputs(make_predict_step(pbundle)(pstate, pb, pd),
                    jax_make_predict_step(jbundle)(jstate, jb, jd), f"{name} predict")
    _, jouts = jax_make_eval_step(jbundle)(jstate, jb, jl, jw, jd,
                                           JM.init_metrics(jbundle.metrics))
    states, pouts = make_eval_step(pbundle)(pstate, pb, pl, pw, pd,
                                            M.init_metrics(pbundle.metrics, "cpu"))
    _assert_outputs(pouts, jouts, f"{name} eval")
    values = M.compute_metrics(pbundle.metrics, states)
    assert all(np.isfinite(float(v)) for ms in values.values() for v in ms.values())


def test_bf16_staytime_service_scores_as_jax():
    """Raw rows through the JAX and the port's scoring services over
    staytime's bf16 tables, some rows without sequence features."""
    jbundle, jstate, pbundle, pstate = _pair("staytime")
    jsvc = JaxScoringService(jbundle, jstate, max_batch=16)
    psvc = ScoringService(pbundle, pstate, max_batch=16, device="cpu")
    rows = _raw_rows(np.random.default_rng(4), 6, CFG16,
                     with_seq=[True, False, True, False, True, True])
    want, got = jsvc.score(rows), psvc.score(rows)
    assert set(got) == set(want) == set(pbundle.tasks)
    for task in want:
        tol = EV_TOL if task == T_STAY else TOL
        np.testing.assert_allclose(got[task], want[task], **tol, err_msg=task)


def test_bridge_takes_bf16_arrays_and_names_a_mismatch():
    """The JAX package's bf16 tables and moments come as numpy
    ``ml_dtypes.bfloat16`` arrays and land bit for bit in bf16; an array of
    another type than the engine stores raises a named ``ValueError``."""
    jbundle, jstate, pbundle, pstate = _pair("autoint")
    classic = jax.device_get(jbundle.embedding.classic_state(jstate.tables))
    for skey, t in classic.items():
        assert np.asarray(t["w"]).dtype.name == "bfloat16"
        got = pstate.tables[skey]
        for name, a, b in [("w", got["w"], t["w"]), ("m", got["opt"]["m"], t["opt"]["m"]),
                           ("v", got["opt"]["v"], t["opt"]["v"]), ("t", got["opt"]["t"],
                                                                   t["opt"]["t"])]:
            assert a.dtype == (torch.float32 if name == "t" else torch.bfloat16), name
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    params = jax.tree.map(np.asarray, jstate.params)
    as32 = jax.tree.map(lambda a: np.asarray(a, np.float32), classic)
    with pytest.raises(ValueError, match="w is float32, the engine stores it in bfloat16"):
        bridge.from_jax_numpy(pbundle, params, as32)
    f32_bundle = create_model("autoint", bucket_size=256, device="cpu")
    with pytest.raises(ValueError, match="w is bfloat16, the engine stores it in float32"):
        bridge.from_jax_numpy(f32_bundle, params, classic)


def test_bf16_checkpoint_round_trips_bit_for_bit(tmp_path):
    """bf16 tables and bf16 moments after a train step survive a save and a
    restore with their types and bits; a float32 checkpoint does not
    restore into a bf16 target (``CheckpointMismatchError``)."""
    kw = dict(bucket_size=256, table_dtype=torch.bfloat16, opt_state_dtype=torch.bfloat16,
              device="cpu")
    bundle = create_model("autoint", **kw)
    batch, dense, labels, w = synthetic_batch(bundle, 16, seed=0)
    state, _ = make_train_step(bundle)(create_train_state(bundle, seed=0), batch, labels, w,
                                       dense, seed=1)
    save_checkpoint(str(tmp_path / "bf16"), state)
    restored = restore_checkpoint(str(tmp_path / "bf16"), create_train_state(bundle, seed=5))
    for skey, t in state.tables.items():
        r = restored.tables[skey]
        for a, b in [(t["w"], r["w"]), (t["show"], r["show"])] + [
                (t["opt"][n], r["opt"][n]) for n in t["opt"]]:
            assert a.dtype == b.dtype and torch.equal(a, b)
    f32 = create_model("autoint", bucket_size=256, device="cpu")
    save_checkpoint(str(tmp_path / "f32"), create_train_state(f32, seed=0))
    with pytest.raises(CheckpointMismatchError, match="float32 in the checkpoint"):
        restore_checkpoint(str(tmp_path / "f32"), create_train_state(bundle, seed=0))


@pytest.mark.parametrize("flag,want", [("bf16", torch.bfloat16), ("auto", "auto"),
                                       ("fp32", None)])
def test_server_table_dtype_flag(monkeypatch, flag, want):
    """``--table-dtype`` reaches the model's factory and the service serves
    tables of that type; ``--compute-dtype bf16`` is refused by name."""
    made, served = [], []

    def create(name, **kw):
        made.append(kw.get("table_dtype"))
        return create_model(name, cfg=StaytimeConfig(**SMALL), deep_hidden_units=HIDDEN, **kw)

    class Server:
        def __init__(self, service):
            served.append(service)

        def serve_forever(self):
            return None

    monkeypatch.setattr(port_server, "create_model", create)
    monkeypatch.setattr(port_server, "serve", lambda svc, port=0: Server(svc))
    port_server.main(["--model", "staytime", "--device", "cpu", "--max-batch", "8",
                      "--table-dtype", flag])
    assert made == [want]
    dtypes = {t["w"].dtype for t in served[0].state.tables.values()}
    assert dtypes == {torch.float32 if want is None else torch.bfloat16}


def test_compute_dtype_bf16_is_refused_by_name(capsys, monkeypatch):
    """Every factory takes ``compute_dtype=torch.bfloat16`` and carries it on
    its bundle, float32 and None give float32, and any other dtype is
    refused by name; the server's ``--compute-dtype bf16`` builds its bundle
    with the policy, and another value is refused."""
    for name, factory in MODEL_REGISTRY.items():
        with pytest.raises(ValueError, match="torch.float32 or torch.bfloat16"):
            factory(compute_dtype=torch.float16, device="cpu")
    for dtype, want in ((None, torch.float32), (torch.float32, torch.float32),
                        (torch.bfloat16, torch.bfloat16)):
        assert create_model("finish", bucket_size=64, compute_dtype=dtype,
                            device="cpu").compute_dtype == want
    with pytest.raises(SystemExit):
        port_server.main(["--model", "staytime", "--device", "cpu", "--compute-dtype", "fp16"])
    assert "invalid choice: 'fp16'" in capsys.readouterr().err
    made = []

    def create(name, **kw):
        made.append(kw.get("compute_dtype"))
        return create_model(name, **kw)

    class Server:
        def __init__(self, svc):
            pass

        def serve_forever(self):
            pass

    monkeypatch.setattr(port_server, "create_model", create)
    monkeypatch.setattr(port_server, "serve", lambda svc, port=0: Server(svc))
    port_server.main(["--model", "finish", "--bucket-size", "64", "--device", "cpu",
                      "--max-batch", "8", "--compute-dtype", "bf16"])
    assert made == [torch.bfloat16]
