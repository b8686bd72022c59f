"""The daily path's host-to-card pieces, on the card.

Every test here carries the ``cuda`` marker, needs a CUDA card and skips
without one (the ``cuda`` fixture decides, at run time).  The file imports
no JAX, so it runs without the suite's conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_daily.py

A checkpoint saved from the card restores on the CPU bit for bit (and back
onto the card); ``dataset_reader(device="cuda")`` yields card tensors equal
to the CPU reader's, and neither it nor ``balance_batches`` makes a host
sync (``torch.cuda.set_sync_debug_mode("error")`` raises on one).
"""

import os

import numpy as np
import pytest
import torch

from recommendsystem_tpu_torch.data.example_proto import encode_example
from recommendsystem_tpu_torch.data.loader import balance_batches, dataset_reader
from recommendsystem_tpu_torch.data.parse import make_staytime_parse_fn
from recommendsystem_tpu_torch.data.tfrecord import write_tfrecord
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
from recommendsystem_tpu_torch.train import (create_train_state, make_train_step,
                                             restore_checkpoint, save_checkpoint)
from recommendsystem_tpu_torch.data import synthetic_batch

pytestmark = pytest.mark.cuda
DAY = "20260801"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def test_a_checkpoint_from_the_card_restores_on_the_cpu(cuda, tmp_path):
    cfg = StaytimeConfig(bucket_size=256, seq_max_len=8)
    card = create_model("staytime", cfg=cfg, device="cuda")
    state = create_train_state(card, seed=4)
    batch, dense, labels, weight = synthetic_batch(card, 64, seed=2)
    step = make_train_step(card)
    for i in range(2):
        state, _ = step(state, batch, labels, weight, dense, seed=i)
    save_checkpoint(str(tmp_path), state)
    cpu = create_model("staytime", cfg=cfg, device="cpu")
    restored = restore_checkpoint(str(tmp_path), create_train_state(cpu, seed=0))
    assert restored.step == 2 and restored.opt_state["count"] == 2
    want = dict(_leaves({"p": state.params, "o": state.opt_state["mu"], "t": state.tables}))
    got = dict(_leaves({"p": restored.params, "o": restored.opt_state["mu"],
                        "t": restored.tables}))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].device.type == "cpu", k
        assert torch.equal(got[k], v.cpu()), k
    # and from the CPU back onto the card
    save_checkpoint(str(tmp_path / "cpu"), restored)
    back = restore_checkpoint(str(tmp_path / "cpu"), create_train_state(card, seed=0))
    for k, v in dict(_leaves({"t": back.tables})).items():
        assert v.device == state.tables[k.split(".")[1]]["w"].device
        assert torch.equal(v.cpu(), got[k]), k


def _write_day(root, slots, n=40):
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, DAY))
    for p in range(2):
        recs = []
        for i in range(n):
            feats = {"extra_info": [f"r{p}-{i}".encode()],
                     "watch_duration": [int(rng.integers(0, 60_000))]}
            for s in slots:
                feats[s] = rng.integers(0, 2 ** 62, rng.integers(1, 6)).tolist()
            recs.append(encode_example(feats))
        write_tfrecord(os.path.join(root, DAY, f"part-{p}"), recs)


def test_reader_copies_to_the_card_without_a_host_sync(cuda, tmp_path):
    bundle = create_model("staytime", cfg=StaytimeConfig(bucket_size=256, seq_max_len=8),
                          device="cpu")
    _write_day(str(tmp_path), bundle.config.slots)
    parse_fn = make_staytime_parse_fn(bundle.embedding)
    args = (str(tmp_path), [DAY], "part-*", 32, parse_fn)
    want = list(dataset_reader(*args, drop_remainder=False, device="cpu"))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = list(balance_batches(dataset_reader(*args, drop_remainder=False,
                                                  device="cuda"), 32))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert len(got) == len(want) == 3                     # 80 records, the last 16 padded
    for (b, d, l, w, e), (wb, wd, wl, ww, we) in zip(got, want):
        n = ww.shape[0]
        for k in wb:
            assert b[k].rows.device.type == "cuda" and b[k].mask.device.type == "cuda"
            assert torch.equal(b[k].rows[:n].cpu(), wb[k].rows), k
            assert torch.equal(b[k].mask[:n].cpu(), wb[k].mask), k
        for t in wl:
            assert torch.equal(l[t][:n].cpu(), wl[t]), t
        assert torch.equal(w[:n].cpu(), ww) and not w[n:].any()
        assert isinstance(e["example_id"], np.ndarray)
        np.testing.assert_array_equal(e["example_id"], we["example_id"])
