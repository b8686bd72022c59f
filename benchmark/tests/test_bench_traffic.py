"""The general traffic generator: the same seed gives the same batches,
another seed other ones; ids skewed (or uniform) as the mix says;
lengths in range and padding zeroed; each rank's block of rows drawn on
its own."""

from __future__ import annotations

import pytest
import torch

from conftest import tiny_cell


def _traffic(name, seed):
    from harness.traffic import Traffic

    cell = tiny_cell(name)
    return Traffic(cell.model, cell.m, cell.traffic, seed, "cpu"), cell


def _same(a, b):
    return all(torch.equal(a[k][c], b[k][c]) for k in ("ids", "mask") for c in a[k]) and \
        all(torch.equal(a["labels"][t], b["labels"][t]) for t in a["labels"])


@pytest.mark.parametrize("name", ["autoint.train", "staytime.train", "staytime.predict"])
def test_deterministic_for_a_seed(name):
    seed = 2 ** 31 + 12345
    a, _ = _traffic(name, seed)
    b, _ = _traffic(name, seed)
    c, _ = _traffic(name, seed + 1)
    for i in range(2):
        assert _same(a.batch(i, 32), b.batch(i, 32))
    assert not _same(a.batch(0, 32), c.batch(0, 32))
    assert not _same(a.batch(0, 32), a.batch(1, 32))


@pytest.mark.parametrize("name", ["autoint.train", "staytime.train"])
def test_lengths_and_padding(name):
    gen, cell = _traffic(name, 7)
    batch = gen.batch(0, 256)
    for key, _, kind, width in cell.model.columns(cell.m):
        lo, hi = cell.traffic["mean_ids"] if kind == "mean" else cell.traffic["seq_len"]
        mask, ids = batch["mask"][key], batch["ids"][key]
        assert ids.shape == (256, width) and ids.dtype == torch.int32
        lens = mask.sum(1)
        assert int(lens.min()) >= lo and int(lens.max()) <= hi
        assert bool((ids[mask == 0] == 0).all())
        assert int(ids.max()) < cell.m["bucket_size"] and int(ids.min()) >= 0


def test_zipf_ids_are_skewed():
    gen, cell = _traffic("autoint.train", 3)
    batch = gen.batch(0, 4096)
    key = cell.m["slots"][0]
    ids = batch["ids"][key][batch["mask"][key] > 0]
    counts = torch.bincount(ids.long(), minlength=cell.m["bucket_size"]).sort(descending=True)[0]
    n = ids.numel()
    # P(rank 0) = 1 / H(1000, 1.05), about 0.14; uniform would give 0.001
    assert counts[0] / n > 0.08
    assert torch.equal(gen.perm[key][0:1], torch.nonzero(
        torch.bincount(ids.long(), minlength=cell.m["bucket_size"]) == counts[0])[0])


def test_uniform_ids_cover_the_bucket():
    from harness.traffic import Traffic

    cell = tiny_cell("autoint.train")
    gen = Traffic(cell.model, cell.m, dict(cell.traffic, ids={"dist": "uniform"}), 3, "cpu")
    batch = gen.batch(0, 4096)
    key = cell.m["slots"][0]
    ids = batch["ids"][key][batch["mask"][key] > 0]
    counts = torch.bincount(ids.long(), minlength=cell.m["bucket_size"])
    assert int(counts.max()) < 0.01 * ids.numel()
    assert int((counts > 0).sum()) > 0.9 * cell.m["bucket_size"]


def test_row_blocks_are_drawn_apart():
    """A rank's rows (``row0``) come from their own draws, the same on
    every call."""
    gen, _ = _traffic("autoint.train", 11)
    whole = gen.batch(2, 64, 0)
    again = gen.batch(2, 64, 0)
    other = gen.batch(2, 64, 64)
    assert _same(whole, again) and not _same(whole, other)
