"""Trained quality of the port against the JAX package's, on the CPU.

Both packages write the synthetic Criteo files (8,192 training rows at
seed 0, 2,048 test rows at seed 99) and train autoint over the 39 Criteo
columns for one epoch of 32 steps (B 256, 4,096-row tables, sparse Adam at
1e-2, dense Adam at 3e-3: ``scripts/torch_auc_parity_criteo.py``'s
learning rates) from the same start: the JAX initial state carried across
by ``bridge.from_jax_numpy``.  Attention dropout is off on both sides (the
JAX layer draws flax dropout, whose stream no port can match).  Test AUC is
the script's exact rank AUC on both sides.  Bounds, fixed before the first
run:

(a) float32: every step's loss within rtol 1e-3 of JAX's in a free run
    that never re-synchronises; both test AUCs > 0.6; |dAUC| and
    |dlogloss| <= 1e-3;
(b) bf16 tables and bf16 Adam moments, against JAX with the same storage
    types: |dAUC| and |dlogloss| <= 3e-3 (a stored bf16 entry one rounding
    apart moves the runs apart);
(c) the bf16 compute policy against the port's own float32 run from the
    same state: |dAUC| <= 5e-3 and AUC > 0.6 (the per-step hold against
    JAX under the policy is ``tests/test_torch_bf16_compute.py``'s);
(d) the script's AUC and logloss against scikit-learn's ``roc_auc_score``
    and ``log_loss`` on seeded data with ties, rtol 1e-12;
(e) the script end to end on the CPU at a small size: its JSON has every
    key, ``AUC_PARITY.json`` keeps its bytes; without a card it raises;
    it imports neither scikit-learn nor TensorFlow, so that it runs where
    neither is installed.

``-s`` prints each run's AUC and logloss.
"""

import ast
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.data import criteo as jcriteo
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train.step import make_predict_step as jax_make_predict_step
from recommendsystem_tpu.train.step import make_train_step as jax_make_train_step
from recommendsystem_tpu_torch import bridge
from test_torch_autoint_train import NO_DROPOUT

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "torch_auc_parity_criteo.py"
N_TRAIN, N_TEST = 8192, 2048
BATCH = 256
BUCKET = 4096
LOSS_RTOL = 1e-3
F32_TOL = 1e-3
BF16_STORAGE_TOL = 3e-3
BF16_COMPUTE_TOL = 5e-3
MIN_AUC = 0.6


def _script():
    spec = importlib.util.spec_from_file_location("torch_auc_parity_criteo", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


script = _script()
TASK = script.TASK


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{"jax": (train, test), "port": (train, test)}, each package's own
    ``write_synthetic_criteo``; the two are byte-equal."""
    jroot, proot = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jpaths = (str(jroot / "train.tsv"), str(jroot / "test.tsv"))
    jcriteo.write_synthetic_criteo(jpaths[0], N_TRAIN, seed=script.TRAIN_SEED)
    jcriteo.write_synthetic_criteo(jpaths[1], N_TEST, seed=script.TEST_SEED)
    ppaths = script.write_files(str(proot), N_TRAIN, N_TEST)
    for j, p in zip(jpaths, ppaths):
        assert Path(j).read_bytes() == Path(p).read_bytes()
    return {"jax": jpaths, "port": ppaths}


def _jax_bundle(**kw):
    return jcriteo.criteo_autoint(dim=script.DIM, bucket_size=BUCKET,
                                  sparse_lr=script.LR_SPARSE, dense_lr=script.LR_DENSE,
                                  model_param=NO_DROPOUT, **kw)


def _jax_run(files, **kw):
    """The JAX run: its initial state as numpy (params, the tables' classic
    view, optax's state), each step's loss, test labels and scores."""
    jbundle = _jax_bundle(**kw)
    train = [(b, l, w) for b, _, l, w, _ in
             jcriteo.criteo_dataset(files["jax"][0], BATCH, jbundle.embedding)]
    test = [(b, l) for b, _, l, _, _ in
            jcriteo.criteo_dataset(files["jax"][1], BATCH, jbundle.embedding)]
    state = jax_create_train_state(jbundle, jax.random.PRNGKey(0), train[0][0])
    init = (jax.tree.map(np.asarray, state.params),
            jax.device_get(jbundle.embedding.classic_state(state.tables)),
            jax.tree.map(np.asarray, state.opt_state))
    step = jax_make_train_step(jbundle, donate=False, sparse_update="packed")
    losses = []
    for i, (b, l, w) in enumerate(train):
        state, info = step(state, b, l, w, None, jax.random.PRNGKey(i))
        losses.append(info["loss"])
    predict = jax_make_predict_step(jbundle)
    p = np.concatenate([np.asarray(predict(state, b, None)[TASK]).ravel() for b, _ in test])
    y = np.concatenate([l[TASK].ravel() for _, l in test])
    return {"init": init, "losses": np.asarray(jnp.stack(losses)), "y": y, "p": p}


def _port_run(files, mode, init):
    """The port's run of ``mode`` from the bridged JAX state ``init``."""
    pbundle = script.make_bundle(mode, "cpu", bucket=BUCKET, model_param=NO_DROPOUT)
    params, tables, opt_state = init
    state = bridge.from_jax_numpy(pbundle, params, tables, opt_state=opt_state)
    train = script.load_batches(files["port"][0], pbundle.embedding, "cpu", BATCH)
    test = script.load_batches(files["port"][1], pbundle.embedding, "cpu", BATCH)
    state, losses, _ = script.train(pbundle, state, train, 1, 0, "cpu")
    y, p = script.predict(pbundle, state, test)
    return {"losses": losses, "y": y, "p": p}


def _quality(run):
    return script.exact_auc(run["y"], run["p"]), script.logloss(run["y"], run["p"])


@pytest.fixture(scope="module")
def jax32(files):
    return _jax_run(files)


@pytest.fixture(scope="module")
def port32(files, jax32):
    return _port_run(files, "float32", jax32["init"])


def test_float32_losses_track_jax_in_a_free_run(jax32, port32):
    assert len(port32["losses"]) == len(jax32["losses"]) == N_TRAIN // BATCH
    np.testing.assert_allclose(port32["losses"], jax32["losses"], rtol=LOSS_RTOL)


def test_float32_trained_quality_matches_jax(jax32, port32):
    np.testing.assert_array_equal(port32["y"], jax32["y"])
    (pauc, pll), (jauc, jll) = _quality(port32), _quality(jax32)
    print(f"float32: AUC port {pauc:.6f} JAX {jauc:.6f}; logloss port {pll:.6f} JAX {jll:.6f}")
    assert pauc > MIN_AUC and jauc > MIN_AUC, (pauc, jauc)
    assert abs(pauc - jauc) <= F32_TOL, (pauc, jauc)
    assert abs(pll - jll) <= F32_TOL, (pll, jll)


def test_bf16_storage_matches_jax_bf16(files, jax32, port32):
    jrun = _jax_run(files, table_dtype=jnp.bfloat16, opt_state_dtype=jnp.bfloat16)
    assert jrun["init"][1][next(iter(jrun["init"][1]))]["w"].dtype.name == "bfloat16"
    prun = _port_run(files, "bf16_storage", jrun["init"])
    (pauc, pll), (jauc, jll) = _quality(prun), _quality(jrun)
    print(f"bf16 storage: AUC port {pauc:.6f} ({pauc - _quality(port32)[0]:+.6f} from its "
          f"float32) JAX {jauc:.6f} ({jauc - _quality(jax32)[0]:+.6f}); logloss port "
          f"{pll:.6f} JAX {jll:.6f}")
    assert pauc > MIN_AUC and jauc > MIN_AUC, (pauc, jauc)
    assert abs(pauc - jauc) <= BF16_STORAGE_TOL, (pauc, jauc)
    assert abs(pll - jll) <= BF16_STORAGE_TOL, (pll, jll)


def test_bf16_compute_tracks_the_ports_float32(files, jax32, port32):
    prun = _port_run(files, "bf16_compute", jax32["init"])
    pauc, fauc = _quality(prun)[0], _quality(port32)[0]
    print(f"bf16 compute: AUC {pauc:.6f}, float32 {fauc:.6f}")
    assert pauc > MIN_AUC, pauc
    assert abs(pauc - fauc) <= BF16_COMPUTE_TOL, (pauc, fauc)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_auc_and_logloss_match_sklearn(seed):
    from sklearn.metrics import log_loss, roc_auc_score

    rng = np.random.default_rng(seed)
    n = 5000
    y = (rng.uniform(size=n) < 0.3).astype(np.float64)
    # scores on a coarse grid, so that many tie, some across the labels;
    # a few past the logloss clip at both ends
    p = np.round(np.clip(0.2 + 0.5 * y + rng.normal(0, 0.25, n), 0, 1), 2)
    p[:10], p[10:20] = 0.0, 1.0
    assert len(np.unique(p)) < n // 10
    np.testing.assert_allclose(script.exact_auc(y, p), roc_auc_score(y, p), rtol=1e-12)
    np.testing.assert_allclose(script.logloss(y, p),
                               log_loss(y, np.clip(p, 1e-6, 1 - 1e-6)), rtol=1e-12)


def test_script_end_to_end_on_the_cpu(tmp_path):
    record = (ROOT / "AUC_PARITY.json").read_bytes()
    out = tmp_path / "auc.json"
    rc = script.main(["--device", "cpu", "--n-train", "2048", "--n-test", "512",
                      "--epochs", "1", "--seeds", "0", "--mode", "all", "--out", str(out)])
    assert rc == 0
    assert (ROOT / "AUC_PARITY.json").read_bytes() == record
    got = json.loads(out.read_text())
    assert set(got) == {"config", "jax", "bounds_held", "data_s", "device", "card", "torch",
                        "cuda", "runs", "summary", "findings"}
    assert got["config"]["n_train"] == 2048 and got["config"]["seeds"] == [0]
    assert got["jax"] == json.loads(record)["summary"]["jax"]
    assert got["bounds_held"] is False and got["findings"] == []
    assert [r["mode"] for r in got["runs"]] == list(script.MODES)
    for r in got["runs"]:
        assert set(r) == {"mode", "seed", "auc", "logloss", "steps", "train_s",
                          "examples_per_s", "last_loss", "device", "card", "torch", "cuda"}
        assert r["steps"] == 4 and 0.5 < r["auc"] <= 1 and np.isfinite(r["logloss"])
    assert set(got["summary"]) == set(script.MODES)
    for s in got["summary"].values():
        assert set(s) == {"auc_mean", "auc_std", "logloss_mean", "logloss_std", "n",
                          "auc_delta_jax", "logloss_delta_jax", "auc_delta_float32",
                          "logloss_delta_float32", "bound"}
        assert s["bound"] is None


def test_script_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        script.main(["--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_bounds_are_held_only_at_the_full_configuration():
    jax = {"auc_mean": 0.774, "logloss_mean": 0.572}
    runs = [{"mode": "float32", "auc": 0.7745, "logloss": 0.5715},
            {"mode": "bf16_storage", "auc": 0.770, "logloss": 0.5716}]
    summary, findings, failed = script.summarize(runs, jax, full=True)
    assert summary["float32"]["bound"]["held"] and not failed
    assert not summary["bf16_storage"]["bound"]["held"]
    assert len(findings) == 1 and findings[0].startswith("bf16_storage")
    runs[0]["auc"] = 0.7715
    assert script.summarize(runs, jax, full=True)[2]
    assert not script.summarize(runs, jax, full=False)[2]


def test_script_imports_neither_sklearn_nor_tensorflow():
    tree = ast.parse(SCRIPT.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("sklearn", "tensorflow"), name
