"""Shared set-up of the benchmark's own tests: the benchmark's folder on
the import path, and each cell cut to a size the CPU runs in seconds (the
program's plain CPU paths stand in for its kernels)."""

from __future__ import annotations

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (BENCH, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY_BUCKET = 1000
TINY_BATCH = 64


def tiny_cell(name: str, traffic: str = None, chips: int = None):
    """Cell ``name`` with tables of ``TINY_BUCKET`` rows, ``TINY_BATCH``
    rows a batch, a pool of 4 and short warm-up and trace; with
    ``traffic`` and ``chips``, run under that mix on that many ranks."""
    import json

    from harness import cells

    cell = cells.load(name)
    if traffic is not None:
        with open(os.path.join(BENCH, "traffic", f"{traffic}.json")) as f:
            cell.traffic = json.load(f)
        cell.chips = chips
    cell.cfg["model"]["bucket_size"] = TINY_BUCKET
    if "bucket_size" in cell.cfg["factory_kwargs"]:
        cell.cfg["factory_kwargs"]["bucket_size"] = TINY_BUCKET
    cell.traffic.update(batch=TINY_BATCH, pool=4, warm_steps=1, trace_steps=2)
    return cell


def _tiny_bundle(cfg, device, num_shards=1):
    """The program's bundle at the tiny bucket (staytime takes its bucket
    in a config object, not a factory argument)."""
    from recommendsystem_tpu_torch.models.base import create_model
    from recommendsystem_tpu_torch.models.staytime import StaytimeConfig

    kw = {"num_shards": num_shards} if num_shards > 1 else {}
    if cfg["factory"] == "staytime":
        return create_model("staytime", device=device,
                            cfg=StaytimeConfig(bucket_size=cfg["model"]["bucket_size"]), **kw)
    return create_model(cfg["factory"], device=device, **cfg["factory_kwargs"], **kw)


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    """One intra-op thread: the tiny runs spend their time in small ops,
    which more threads only slow on a shared host (as ``run.py`` runs)."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def tiny(monkeypatch):
    from harness import program

    monkeypatch.setattr(program, "build_bundle", _tiny_bundle)
    return tiny_cell


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none (decided in the test,
    never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
