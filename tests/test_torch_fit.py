"""``harness.fit`` of the port: the steps it takes are the train step's with
the seeds of ``seed_stream``; ``scan_steps`` gives the same steps;
``resume`` after a checkpoint continues bit for bit; ``evict_every``,
``nan_guard``, ``history_path``, ``profile_dir`` and the callbacks.

Everything runs on the CPU through the plain versions, where a step is
deterministic, so equal steps are held bit for bit.  Autoint at 64-id
buckets, B = 16; dropout stays on except for the resume check, where the
resumed ``fit`` restarts its seed stream (as the JAX ``fit`` restarts its
key)."""

import json
import os
import types

import pytest
import torch

from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.train import create_train_state, fit, make_train_step
from recommendsystem_tpu_torch.train.harness import seed_stream
from test_torch_autoint_train import NO_DROPOUT
from test_torch_checkpoint import assert_states_equal

torch.set_num_threads(1)
B = 16
N = 6


def _bundle(**kw):
    return create_model("autoint", bucket_size=64, device="cpu", **kw)


def _batches(bundle, n=N):
    return [synthetic_batch(bundle, B, seed=40 + i) for i in range(n)]


def test_fit_takes_the_train_steps_with_its_seeds():
    bundle = _bundle()
    data = _batches(bundle)
    got = fit(bundle, iter(data), seed=7, log_every=0)
    seeds = seed_stream(7)
    want = create_train_state(bundle, seed=next(seeds))
    step = make_train_step(bundle)
    for b, d, l, w in data:
        want, _ = step(want, b, l, w, d, seed=next(seeds))
    assert got.step == N
    assert_states_equal(got, want)
    # another seed: another init and other dropout
    other = fit(bundle, iter(data), seed=8, log_every=0)
    assert not torch.equal(other.params["logits.dense_0.kernel"],
                           got.params["logits.dense_0.kernel"])


def test_seed_stream_is_a_seeded_generator():
    a, b = seed_stream(3), seed_stream(3)
    first = [next(a) for _ in range(5)]
    assert first == [next(b) for _ in range(5)]
    assert all(0 <= s < 2 ** 32 for s in first) and len(set(first)) == 5
    assert next(seed_stream(4)) != first[0]


@pytest.mark.parametrize("scan_steps,steps", [(3, None), (4, None), (4, 5)])
def test_scan_steps_equal_single_steps(scan_steps, steps):
    """K items a dispatch, short tails one by one, ``steps`` cutting a
    chunk: the same states and the same callbacks' step numbers, at the
    chunk boundaries."""
    bundle = _bundle()
    data = _batches(bundle)
    state0 = create_train_state(bundle, seed=1)
    calls = []
    single = fit(bundle, iter(data), steps=steps, state=state0, seed=2, log_every=0)
    state1 = create_train_state(bundle, seed=1)
    scanned = fit(bundle, iter(data), steps=steps, state=state1, seed=2, log_every=0,
                  scan_steps=scan_steps, callbacks=[lambda i, s, info: calls.append(i)])
    assert_states_equal(scanned, single)
    total = steps or N
    assert scanned.step == total
    want = list(range(scan_steps, total + 1, scan_steps))
    assert calls == want + ([total] if total % scan_steps else [])


def test_resume_continues_bit_for_bit(tmp_path):
    bundle = _bundle(model_param=NO_DROPOUT)
    data = _batches(bundle)
    whole = fit(bundle, iter(data), seed=5, log_every=0)
    ckpt = str(tmp_path / "ck")
    first = fit(bundle, iter(data[:3]), seed=5, log_every=0, checkpoint_dir=ckpt,
                checkpoint_every=3)
    assert os.listdir(ckpt) == ["3"] and first.step == 3
    resumed = fit(bundle, iter(data[3:]), seed=5, log_every=0, checkpoint_dir=ckpt,
                  checkpoint_every=3, resume=True)
    assert resumed.step == N
    assert_states_equal(resumed, whole)
    assert sorted(os.listdir(ckpt)) == ["3", "6"]
    # resume=True over an empty directory starts afresh
    fresh = fit(bundle, iter(data[:1]), seed=5, log_every=0,
                checkpoint_dir=str(tmp_path / "empty"), resume=True)
    assert fresh.step == 1


def test_evict_every_calls_maybe_evict(monkeypatch):
    bundle = _bundle()
    calls = []
    real = bundle.embedding.maybe_evict

    def spy(tables, generator=None):
        calls.append(generator.device)
        return real(tables, generator)

    monkeypatch.setattr(bundle.embedding, "maybe_evict", spy)
    fit(bundle, iter(_batches(bundle, 5)), log_every=0, evict_every=2)
    assert calls == [bundle.device] * 2
    # the eviction draws from the seed stream: the later steps' seeds move
    calls.clear()
    fit(bundle, iter(_batches(bundle, 5)), log_every=0, evict_every=2, scan_steps=3)
    assert len(calls) == 2                    # at steps 3 (>= 2) and 5 (>= 4)


@pytest.mark.parametrize("guard", ["raise", "warn", "off"])
def test_nan_guard(guard, caplog):
    bundle = _bundle()
    state = create_train_state(bundle, seed=0)
    state.params["logits.dense_0.bias"].fill_(float("nan"))
    data = iter(_batches(bundle, 2))
    if guard == "raise":
        with pytest.raises(FloatingPointError, match="non-finite loss .* at step 1"):
            fit(bundle, data, state=state, log_every=1, nan_guard=guard)
        return
    out = fit(bundle, data, state=state, log_every=1, nan_guard=guard)
    assert out.step == 2
    warned = [r for r in caplog.records if "non-finite loss" in r.getMessage()]
    assert len(warned) == (2 if guard == "warn" else 0)


def test_nan_guard_rejects_unknown_values():
    with pytest.raises(ValueError, match="nan_guard"):
        fit(_bundle(), iter(()), nan_guard="maybe")


def test_history_lines(tmp_path):
    bundle = _bundle()
    path = str(tmp_path / "history.jsonl")
    fit(bundle, iter(_batches(bundle, 5)), log_every=2, history_path=path)
    lines = [json.loads(x) for x in open(path).read().splitlines()]
    assert [x["step"] for x in lines] == [2, 4]
    task = "video_id_rank_skip_model"
    for x in lines:
        assert set(x) == {"step", "examples_per_sec", "loss", f"loss/{task}",
                          "regularization"}
        assert x["loss"] > 0
    # the rate runs from one log point's host read to the next: none at the first
    assert lines[0]["examples_per_sec"] is None and lines[1]["examples_per_sec"] > 0


def test_history_rate_counts_the_interval_between_reads(tmp_path, monkeypatch, caplog):
    """With a patched clock read once at each log point (after its host
    read of the loss): examples since the previous log point over the time
    since its read."""
    from recommendsystem_tpu_torch.train import harness

    reads = iter([100.0, 102.0, 106.0])
    monkeypatch.setattr(harness, "time", types.SimpleNamespace(perf_counter=lambda: next(reads)))
    bundle = _bundle()
    path = str(tmp_path / "history.jsonl")
    with caplog.at_level("INFO", logger=harness.log.name):
        fit(bundle, iter(_batches(bundle, 6)), log_every=2, history_path=path)
    lines = [json.loads(x) for x in open(path).read().splitlines()]
    assert [x["step"] for x in lines] == [2, 4, 6]
    assert [x["examples_per_sec"] for x in lines] == [None, 2 * B / 2.0, 2 * B / 4.0]
    logged = [r.getMessage() for r in caplog.records if "examples/s" in r.getMessage()]
    assert [m.split("examples/s=")[1] for m in logged] == ["n/a", "16.0", "8.0"]


def test_profile_dir_writes_a_trace(tmp_path):
    bundle = _bundle()
    out = str(tmp_path / "prof")
    fit(bundle, iter(_batches(bundle, 4)), log_every=0, profile_dir=out,
        profile_steps=(1, 3))
    trace = json.load(open(os.path.join(out, "trace.json")))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)


def test_fit_refuses_other_modes(tmp_path):
    """The sharded mode without a mesh (with a checkpoint too: a sharded
    checkpoint is a collective over the mesh,
    ``tests/test_torch_sharded_checkpoint.py``) and an unknown mode."""
    with pytest.raises(ValueError, match="mode 'sharded' needs a mesh"):
        fit(_bundle(), iter(()), mode="sharded")
    with pytest.raises(ValueError, match="mode 'pipeline'"):
        fit(_bundle(), iter(()), mode="pipeline")
    with pytest.raises(ValueError, match="mode 'sharded' needs a mesh"):
        fit(_bundle(), iter(()), mode="sharded", checkpoint_dir=str(tmp_path / "ckpt"))
    assert not (tmp_path / "ckpt").exists()
