"""The port's slice as a whole: the autoint predict step and the scoring
service against the JAX package, weights carried by
``bridge.from_jax_numpy``.

Tolerance rtol 1e-5, atol 2e-6: the float32 matrix products are summed in
another order by XLA-CPU and torch."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.serving import ScoringService as JaxScoringService
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train.step import make_predict_step as jax_make_predict_step
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.autoint import TASK
from recommendsystem_tpu_torch.serving import ScoringService, serve
from recommendsystem_tpu_torch.serving import server as port_server
from recommendsystem_tpu_torch.train import create_train_state, make_predict_step

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)


@pytest.fixture(scope="module")
def pair():
    """(JAX bundle, JAX state, port bundle, port state) at bucket 256."""
    jbundle = jax_create_model("autoint", bucket_size=256)
    jbatch, _, _, _ = jax_synthetic_batch(jbundle, 16, seed=0)
    jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(0), jbatch)
    pbundle = create_model("autoint", bucket_size=256, device="cpu")
    pstate = bridge.from_jax_numpy(
        pbundle, jax.tree.map(np.asarray, jstate.params),
        {k: np.asarray(v) for k, v in jbundle.embedding.weights(jstate.tables).items()})
    return jbundle, jstate, pbundle, pstate


@pytest.mark.parametrize("ids_per_feature", [5, 1])
def test_predict_step_matches_jax(pair, ids_per_feature):
    jbundle, jstate, pbundle, pstate = pair
    jbatch, _, _, _ = jax_synthetic_batch(jbundle, 96, seed=11,
                                          ids_per_feature=ids_per_feature)
    pbatch, _, labels, weight = synthetic_batch(pbundle, 96, seed=11,
                                                ids_per_feature=ids_per_feature)
    for k in jbatch:
        np.testing.assert_array_equal(pbatch[k].rows.numpy(), jbatch[k].rows)
        np.testing.assert_array_equal(pbatch[k].mask.numpy(), jbatch[k].mask)
    want = jax_make_predict_step(jbundle)(jstate, jbatch, None)
    got = make_predict_step(pbundle)(pstate, pbatch)
    assert set(got) == set(want) == {TASK}
    assert got[TASK].shape == (96, 1)
    np.testing.assert_allclose(got[TASK].numpy(), np.asarray(want[TASK]), **TOL)
    assert labels[TASK].shape == (96, 1) and weight.shape == (96, 1)


def _rows(n, width=3, salt=0):
    return [{str(1000 + s): [s * 7919 + i * 31 + j + salt for j in range(width)]
             for s in range(24)} for i in range(n)]


@pytest.fixture(scope="module")
def services(pair):
    jbundle, jstate, pbundle, pstate = pair
    return (JaxScoringService(jbundle, jstate, max_batch=16),
            ScoringService(pbundle, pstate, max_batch=16, device="cpu"))


def test_score_matches_jax_service(services):
    jsvc, psvc = services
    rows = _rows(5) + [{}, {"1003": [-5, 2 ** 62]}]
    want = jsvc.score(rows)
    got = psvc.score(rows)
    assert set(got) == set(want) == {TASK}
    np.testing.assert_allclose(got[TASK], want[TASK], **TOL)
    assert all(1e-6 <= s <= 1.0 for s in got[TASK])


def test_padding_does_not_change_a_row(services):
    _, psvc = services
    rows = _rows(11, salt=5)                  # bucket 16
    full = psvc.score(rows)[TASK]
    for i in (0, 7):
        alone = psvc.score([rows[i]])[TASK]   # bucket 8
        np.testing.assert_allclose(alone[0], full[i], **TOL)


def test_oversize_and_overwide_rejected(services):
    _, psvc = services
    with pytest.raises(ValueError, match="exceeds max_batch"):
        psvc.score([{}] * 17)
    with pytest.raises(ValueError, match="compiled width"):
        psvc.score(_rows(1, width=6))
    assert psvc.score([]) == {}


def test_warmup_runs_every_bucket(services):
    _, psvc = services
    assert psvc.buckets == [8, 16]
    psvc.warmup()


def test_http_roundtrip(services):
    _, psvc = services
    httpd = serve(psvc, port=0)               # ephemeral port
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health == {"status": "ok", "model": "autoint", "step": 0}

        rows = _rows(3)
        req = urllib.request.Request(
            f"{base}/score", data=json.dumps({"rows": rows}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            resp = json.loads(r.read())
        assert resp["batch"] == 3
        np.testing.assert_allclose(resp["scores"][TASK],
                                   psvc.score(rows)[TASK], rtol=0, atol=0)

        for body in (b"not json{", json.dumps({"rows": _rows(1, width=9)}).encode()):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(urllib.request.Request(
                    f"{base}/score", data=body), timeout=30)
            assert err.value.code == 400
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_seeded_init_is_reproducible_and_in_range():
    bundle = create_model("autoint", bucket_size=256, device="cpu")
    a, b = create_train_state(bundle, 3), create_train_state(bundle, 3)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    w = a.tables["group_336x8"]["w"]
    assert torch.equal(w, b.tables["group_336x8"]["w"])
    assert w.shape == (24 * 336, 8)
    assert float(w.abs().max()) <= 2.0 / 8 ** 0.5
    assert abs(float(w.std()) * 8 ** 0.5 - 0.88) < 0.05   # std of N(0,1) cut at 2


def test_bridge_rejects_mismatches(pair):
    jbundle, jstate, pbundle, _ = pair
    params = jax.tree.map(np.asarray, jstate.params)
    tables = {k: np.asarray(v)
              for k, v in jbundle.embedding.weights(jstate.tables).items()}
    with pytest.raises(ValueError, match="params"):
        bridge.from_jax_numpy(pbundle, {"mlp": params["mlp"]}, tables)
    with pytest.raises(ValueError, match="storages"):
        bridge.from_jax_numpy(pbundle, params, {"other": tables["group_336x8"]})
    with pytest.raises(ValueError, match="shape"):
        bridge.from_jax_numpy(pbundle, params,
                              {"group_336x8": tables["group_336x8"][:8]})


def test_entry_points_raise_without_cuda(monkeypatch, pair):
    _, _, pbundle, pstate = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("autoint", bucket_size=256)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScoringService(pbundle, pstate)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_server.main(["--model", "autoint", "--bucket-size", "256"])
