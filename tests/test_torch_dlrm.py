"""DLRM-DCNv2 on the port, on the CPU at a tiny size.

- ``LowRankCrossNet`` against plain autograd of the same recurrence, and
  K10's plain version (``kernels/dcn_cross.py``) against its definition;
- the ``dlrm_dcnv2`` bundle's storages: every D-128 table a storage of its
  own on the fold path, none classic;
- the benchmark's traffic for the configuration: every column full to its
  table's hotness (214 ids an example);
- the bundle at small rows (D 128, every hotness up to 100) against the
  benchmark's plain reference (``benchmark/reference/dlrm_dcnv2.py``):
  from the harness's seeded weights and batches, three steps of ``fit``
  and the reference's three steps give the same losses, first gradients
  and changes (the harness's own numbers, ``harness/compare.py``).

Tolerances: the cross net's output and gradients atol 2e-5 (sums over 24
to 96 terms in another order); K10's du and x0's gradient exact (each
product and sum rounds once, in the plain version's order), db's partial
sums atol 1e-5; the bundle against the reference 1e-5 on every number
(the harness's limits on the card are wider).
"""

import os
import sys
import time

import pytest
import torch

from recommendsystem_tpu_torch.embedding import packed
from recommendsystem_tpu_torch.kernels import dcn_cross
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.dlrm_dcnv2 import HOTNESS, ROWS, TABLES
from recommendsystem_tpu_torch.nn import LowRankCrossNet

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")

torch.set_num_threads(1)
SMALL_ROWS = 300


def _plain_cross(x0, params):
    x = x0
    for i in range(0, len(params), 3):
        v, w, b = params[i:i + 3]
        x = x0 * ((x @ v) @ w + b) + x
    return x


@pytest.mark.parametrize("rows,f,rank,layers", [(70, 24, 5, 3), (33, 96, 8, 1), (64, 40, 4, 2)])
def test_low_rank_cross_matches_autograd(rows, f, rank, layers):
    gen = torch.Generator().manual_seed(rows + f)
    net = LowRankCrossNet(f, rank, layers)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    x = torch.randn((rows, f), generator=gen).requires_grad_()
    g = torch.randn((rows, f), generator=gen)
    out = net(x)
    got = torch.autograd.grad(out, [x, *net.parameters()], g)
    leaves = [x.detach().requires_grad_()] + [p.detach().requires_grad_()
                                              for p in net.parameters()]
    want_out = _plain_cross(leaves[0], leaves[1:])
    want = torch.autograd.grad(want_out, leaves, g)
    torch.testing.assert_close(out, want_out, rtol=0, atol=2e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
    with torch.no_grad():
        torch.testing.assert_close(net(x), want_out.detach(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("accumulate,residual", [(False, False), (True, False), (True, True),
                                                 (False, True)])
def test_dcn_cross_plain(accumulate, residual):
    gen = torch.Generator().manual_seed(3)
    g, x0, u, dx0 = torch.randn((4, 75, 12), generator=gen).unbind(0)
    before = dx0.clone()
    du, partial = dcn_cross.dcn_cross_bwd(g, x0, u, dx0, accumulate, residual)
    want = g * u
    if accumulate:
        want = before + want
    if residual:
        want = want + g
    assert torch.equal(du, g * x0) and torch.equal(dx0, want)
    assert partial.shape == (dcn_cross.tiles_of(75), 12) == (3, 12)
    for t in range(3):
        torch.testing.assert_close(partial[t], du[t * 32:(t + 1) * 32].sum(0), rtol=0,
                                   atol=1e-5)


def test_dcn_cross_refuses_other_shapes():
    a = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="shape"):
        dcn_cross.dcn_cross_bwd(a, a, torch.zeros((4, 9)), a.clone(), True, False)
    with pytest.raises(TypeError, match="float32"):
        dcn_cross.dcn_cross_bwd(a.double(), a, a, a.clone(), True, False)


@pytest.fixture
def bench(monkeypatch):
    """The benchmark's top-level modules (``harness``, ``reference``, ...)
    importable for one test: its directory first on the path, and the
    modules it loaded from there dropped again afterwards, so that no
    later test of the session imports them by those names."""
    before = set(sys.modules)
    monkeypatch.syspath_prepend(BENCH)
    yield
    for name in set(sys.modules) - before:
        if (getattr(sys.modules[name], "__file__", None) or "").startswith(BENCH + os.sep):
            del sys.modules[name]


def _small_bundle():
    return create_model("dlrm_dcnv2", rows=[min(r, SMALL_ROWS) for r in ROWS], device="cpu")


def test_every_wide_storage_takes_the_fold_path():
    bundle = _small_bundle()
    eng = bundle.embedding
    assert sorted(eng.storage) == sorted(TABLES)
    assert all(d == 128 for _, d in eng.storage.values())
    pk, classic = packed.storages_packed(eng)
    assert classic == [] and sorted(pk) == sorted(TABLES)
    # each table a storage of its own, its rows as they come
    assert all(eng.table_map[t] == (t, 0, min(r, SMALL_ROWS)) for t, r in zip(TABLES, ROWS))


def _tiny_cell():
    from harness import cells

    cell = cells.load("dlrm_dcnv2.train")
    rows = [min(cell.m[f"rows_{t}"], SMALL_ROWS) for t in cell.m["tables"]]
    for t, r in zip(cell.m["tables"], rows):
        cell.m[f"rows_{t}"] = r
    cell.cfg["factory_kwargs"]["rows"] = rows
    cell.traffic.update(batch=24, pool=4, warm_steps=1, trace_steps=2)
    return cell


def test_traffic_fills_every_column_to_its_hotness(bench):
    from harness.traffic import Traffic

    cell = _tiny_cell()
    assert cell.m["tables"] == list(TABLES) and cell.m["hotness"] == list(HOTNESS)
    batch = Traffic(cell.model, cell.m, cell.traffic, 2 ** 33 + 5, "cpu").batch(0, 24)
    for t, h in zip(TABLES, HOTNESS):
        assert batch["ids"][t].shape == (24, h) and bool((batch["mask"][t] == 1).all())
    assert sum(int(m.sum()) for m in batch["mask"].values()) == 24 * 214
    assert sorted(batch["dense"]) == sorted(f"I{i}" for i in range(1, 14))
    assert all(v.shape == (24, 1) and bool((v >= 0).all()) for v in batch["dense"].values())


def test_bundle_matches_the_benchmark_reference(bench):
    from harness import runner

    s = runner.Session(_tiny_cell(), 2 ** 33 + 11, 1.0, "cpu", time.time())
    s.setup()
    prog = s.check_steps()
    assert len(prog["loss"]) == 3
    numbers = s.reference_numbers(prog)
    assert set(numbers) == {"loss", "grad", "change", "grad_group"}
    assert all(v < 1e-5 for v in numbers.values()), numbers
    groups = s.diagnostics["grad_state"]["groups"]
    assert set(groups) == {"cross", "bottom", "top", "logit", "table"}
