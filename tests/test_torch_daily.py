"""The port's daily trainer and the server's ``--checkpoint``, on the CPU.

``daily.main --device cpu`` over two days of finish records: both days
train, the marker names the second, a second run is a no-op, the
checkpoint of each day is there, ``backtest.jsonl`` has the keys of the
JAX ``daily.main``'s on the same files (the values differ: the two
packages draw other initial weights), and the prediction dump has one
``example_id \\t score`` line a record of the last day.  The server's
``main --checkpoint`` serves the restored state: ``/healthz`` reports its
step and ``/score`` its scores (rtol 1e-5, atol 2e-6).  Dates as
``tests/test_utils.py`` checks the JAX helpers.
"""

import json
import os
import socket
import threading
import urllib.request

import numpy as np
import pytest
import torch

from recommendsystem_tpu.train import daily as jdaily
from recommendsystem_tpu.utils import date_range as jdate_range
from recommendsystem_tpu.utils import trained_delta_days as jtrained_delta_days
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.serving import ScoringService
from recommendsystem_tpu_torch.serving import server
from recommendsystem_tpu_torch.train import create_train_state, daily, restore_checkpoint
from recommendsystem_tpu_torch.utils import date_range, trained_delta_days
from test_torch_data import DAYS, write_ctr_day

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)
SLOTS = tuple(str(s) for s in range(3000, 3040))
TASK = "video_id_rank_finish_nb_lr_rongh_bundle"


@pytest.mark.parametrize("args,want", [
    (("20260228", "20260302"), ["20260228", "20260301", "20260302"]),
    (("20261231", "20270101"), ["20261231", "20270101"]),
    (("20260817", "20260816"), []),
])
def test_date_range(args, want):
    assert date_range(*args) == jdate_range(*args) == want


@pytest.mark.parametrize("last,kw,want", [
    ("20260814", dict(today="20260817"), ["20260815", "20260816", "20260817"]),
    ("20260817", dict(today="20260817"), []),
    ("20260820", dict(today="20260817"), []),
    (None, dict(today="20260817", max_days=3), ["20260815", "20260816", "20260817"]),
    ("20260101", dict(today="20260817", max_days=5),
     ["20260813", "20260814", "20260815", "20260816", "20260817"]),
])
def test_trained_delta_days(last, kw, want):
    assert trained_delta_days(last, **kw) == jtrained_delta_days(last, **kw) == want


def _args(data, state, *extra):
    return ["--model", "finish", "--data-dir", data, "--state-dir", state,
            "--batch-size", "16", "--bucket-size", "256", "--today", DAYS[1],
            "--log-every", "2", *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two days of finish records (2 shards of 24 a day), trained by the
    port's ``daily.main`` with backtest, eviction and a dump."""
    root = tmp_path_factory.mktemp("daily")
    data, state = str(root / "data"), str(root / "state")
    for i, day in enumerate(DAYS):
        write_ctr_day(data, day, SLOTS, per_shard=24, seed=i)
    pred = str(root / "pred.tsv")
    final = daily.main(_args(data, state, "--backtest", "--evict-min-show", "1",
                             "--predict-out", pred, "--device", "cpu"))
    return dict(root=root, data=data, state=state, pred=pred, final=final)


def test_daily_trains_both_days_and_reruns_as_a_no_op(trained):
    state_dir = trained["state"]
    assert daily.read_marker(state_dir) == DAYS[1]
    assert sorted(os.listdir(os.path.join(state_dir, "ckpt")), key=int) == ["3", "6"]
    assert trained["final"].step == 6          # 48 records a day, 16 a step
    assert daily.main(_args(trained["data"], state_dir, "--device", "cpu")) is None
    assert sorted(os.listdir(os.path.join(state_dir, "ckpt")), key=int) == ["3", "6"]
    restored = restore_checkpoint(os.path.join(state_dir, "ckpt"),
                                  create_train_state(create_model(
                                      "finish", bucket_size=256, device="cpu")))
    for k, v in trained["final"].params.items():
        assert torch.equal(restored.params[k], v), k


def test_backtest_keys_equal_the_jax_trainers(trained, tmp_path):
    lines = [json.loads(x) for x in
             open(os.path.join(trained["state"], "backtest.jsonl")).read().splitlines()]
    assert [x["day"] for x in lines] == [DAYS[1]] and lines[0]["step"] == 3
    assert all(np.isfinite(v) for k, v in lines[0].items() if k != "day")
    jstate = str(tmp_path / "jax_state")
    jdaily.main(_args(trained["data"], jstate, "--backtest"))
    jlines = [json.loads(x) for x in
              open(os.path.join(jstate, "backtest.jsonl")).read().splitlines()]
    assert [list(x) for x in lines] == [list(x) for x in jlines]
    assert set(lines[0]) == {"day", "step", f"{TASK}/acc", f"{TASK}/auc"}


def test_prediction_dump_has_a_line_a_record(trained):
    rows = [x.split("\t") for x in open(trained["pred"]).read().splitlines()]
    assert len(rows) == 48
    assert [r[0] for r in rows[:2]] == [f"{DAYS[1]}-0", f"{DAYS[1]}-1"]
    assert len({r[0] for r in rows}) == 48
    assert all(len(r) == 2 and 0.0 < float(r[1]) < 1.0 for r in rows)


def test_daily_refuses_bf16_and_foreign_bucket_flags(capsys, monkeypatch):
    """The compute and table dtype flags reach the model's factory
    (``--compute-dtype bf16``, bf16 or auto tables); a compute dtype other
    than fp32 and bf16 is refused by name, as a bucket size for a model that
    takes none."""
    with pytest.raises(SystemExit):
        daily.main(_args("/nonexistent", "/nonexistent", "--device", "cpu",
                         "--compute-dtype", "fp16"))
    assert "invalid choice: 'fp16'" in capsys.readouterr().err
    made = []

    def create(name, **kw):
        made.append((kw.get("table_dtype"), kw.get("compute_dtype")))
        return create_model(name, **kw)

    monkeypatch.setattr(daily, "create_model", create)
    for flag, want in (("bf16", torch.bfloat16), ("auto", "auto"), ("fp32", None)):
        assert daily.main(_args("/nonexistent", "/nonexistent", "--device", "cpu",
                                "--table-dtype", flag)) is None      # nothing to train
        assert made[-1] == (want, None)
    assert daily.main(_args("/nonexistent", "/nonexistent", "--device", "cpu",
                            "--compute-dtype", "bf16", "--table-dtype", "auto")) is None
    assert made[-1] == ("auto", torch.bfloat16)
    with pytest.raises(SystemExit):
        daily.main(["--model", "staytime", "--data-dir", "x", "--state-dir", "y",
                    "--bucket-size", "64", "--device", "cpu"])
    assert "takes no bucket size" in capsys.readouterr().err


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url, body=None):
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_server_serves_the_restored_checkpoint(trained, monkeypatch):
    started, ready = {}, threading.Event()
    real_serve = server.serve

    def serve(service, port=8000, host="127.0.0.1"):
        started["httpd"] = real_serve(service, port, host)
        started["service"] = service
        ready.set()
        return started["httpd"]

    monkeypatch.setattr(server, "serve", serve)
    port = _free_port()
    ckpt = os.path.join(trained["state"], "ckpt")
    thread = threading.Thread(target=server.main, args=([
        "--model", "finish", "--bucket-size", "256", "--checkpoint", ckpt,
        "--device", "cpu", "--port", str(port), "--max-batch", "32"],), daemon=True)
    thread.start()
    try:
        assert ready.wait(120)
        base = f"http://127.0.0.1:{port}"
        assert _get(f"{base}/healthz") == {"status": "ok", "model": "finish", "step": 6}
        rng = np.random.default_rng(9)
        rows = [{s: rng.integers(0, 2 ** 62, rng.integers(1, 6)).tolist()
                 for s in SLOTS if rng.uniform() < 0.8} for _ in range(20)]
        got = _get(f"{base}/score", {"rows": rows})
        assert got["batch"] == 20
        bundle = create_model("finish", bucket_size=256, device="cpu")
        state = restore_checkpoint(ckpt, create_train_state(bundle, seed=0))
        want = ScoringService(bundle, state, max_batch=32, device="cpu").score(rows)
        np.testing.assert_allclose(got["scores"][TASK], want[TASK], **TOL)
        fresh = ScoringService(bundle, create_train_state(bundle, seed=0), max_batch=32,
                               device="cpu").score(rows)
        assert not np.allclose(fresh[TASK], want[TASK], **TOL)
    finally:
        if "httpd" in started:
            started["httpd"].shutdown()
            started["httpd"].server_close()
        thread.join(60)
    assert not thread.is_alive()
