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


def _digest(batch) -> str:
    import hashlib

    h = hashlib.sha256()
    for part in ("ids", "mask", "labels"):
        for k in sorted(batch[part]):
            t = batch[part][k].contiguous()
            h.update(f"{part}:{k}:{t.dtype}:{tuple(t.shape)}".encode())
            h.update(t.numpy().tobytes())
    h.update(batch["weight"].numpy().tobytes())
    return h.hexdigest()


# sha256 of pool batch 0 (rows 0-63, and rows 192-255 as rank 3 of four
# draws them) of each cell at the tiny size, seed 2**31 + 4099, as the
# generator drew them before it drew dense features (CPU, torch 2.13; the
# four-card mix draws as autoint.train's does)
PARENT_DRAWS = {
    "autoint.train": ("3fa1871a63837f7f8bde1c643094510908f17eed251cf4599c92b5f22d61a9dd",
                      "d106ad2e99c9842656204cfab9d911082ce43a194bd3807d1291396fa4e3bc28"),
    "autoint.train.dp4": ("3fa1871a63837f7f8bde1c643094510908f17eed251cf4599c92b5f22d61a9dd",
                          "d106ad2e99c9842656204cfab9d911082ce43a194bd3807d1291396fa4e3bc28"),
    "staytime.train": ("80a5b5539cc08cb1f3d6a6b44efb03c16c9b852db2beae810387a309e20d0e3f",
                       "70f0cea6b9abbd1a28432718b40203b521b06fc0deda66c42b1fcb6dcbfa70da"),
    "staytime.predict": ("80a5b5539cc08cb1f3d6a6b44efb03c16c9b852db2beae810387a309e20d0e3f",
                         "70f0cea6b9abbd1a28432718b40203b521b06fc0deda66c42b1fcb6dcbfa70da"),
}


@pytest.mark.parametrize("name", sorted(PARENT_DRAWS))
def test_existing_cells_draw_the_same_batches(name):
    """A cell whose configuration has no dense features draws, bit for
    bit, the batches it drew before the generator drew dense features."""
    gen, cell = _traffic(name, 2 ** 31 + 4099)
    b = cell.traffic["batch"]
    first, rank3 = gen.batch(0, b), gen.batch(0, b, 3 * b)
    assert "dense" not in first
    assert (_digest(first), _digest(rank3)) == PARENT_DRAWS[name]
