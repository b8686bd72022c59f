"""The DLRM-DCNv2 configuration's counts against hand counts and the
program's model, its cut against its published rows, and its K10 reader
on a trace with and without the kernel."""

from __future__ import annotations

import json
import os

import torch

from conftest import BENCH, ROOT


def _cell():
    from harness import cells

    return cells.load("dlrm_dcnv2.train")


def test_flops_per_example_by_hand():
    from counts import dlrm_dcnv2

    m = _cell().m
    bottom = 13 * 512 + 512 * 256 + 256 * 128
    cross = 3 * 2 * 3456 * 512
    top = 3456 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256
    assert bottom + cross + top == 16_030_464
    assert dlrm_dcnv2.flops_per_example(m) == 2 * 16_030_464


def test_dense_params_match_the_programs_model():
    from counts import dlrm_dcnv2
    from recommendsystem_tpu_torch.models.dlrm_dcnv2 import DLRMDCNv2

    assert dlrm_dcnv2.dense_params(_cell().m) == sum(p.numel() for p in DLRMDCNv2().parameters())


def test_the_cut_keeps_a_quarter_of_each_large_table():
    with open(os.path.join(BENCH, "configs", "dlrm_dcnv2.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entry = {c["name"]: c for c in json.load(f)["configs"]}["dlrm_dcnv2"]
    m = cfg["model"]
    assert entry["reduced"] == cfg["reduced"] == [f"rows_{t}" for t in cfg["published_rows"]]
    for t, rows in cfg["published_rows"].items():
        assert rows > 1_000_000 and m[f"rows_{t}"] == -(-rows // 4)
    held = [m[f"rows_{t}"] for t in m["tables"]]
    assert cfg["factory_kwargs"]["rows"] == held and sum(held) == 51_883_621
    assert sum(held) - sum(m[f"rows_{t}"] for t in cfg["published_rows"]) == 1_116_632
    assert sum(m["hotness"]) == 214 and m["dim"] == 128


def test_k10_and_k9_counts_by_hand():
    from counts import dlrm_dcnv2

    m = dict(_cell().m)
    ids = {t: torch.zeros((4, h), dtype=torch.int32) for t, h in zip(m["tables"], m["hotness"])}
    mask = {t: torch.ones((4, h)) for t, h in zip(m["tables"], m["hotness"])}
    ids["C1"][0, 0] = 5                      # C1: rows 0 and 5 live, every other table row 0
    batch = {"ids": ids, "mask": mask}
    nbytes, ops = dlrm_dcnv2.kernel(m, "dcn_cross", batch)
    assert (nbytes, ops) == (3 * (5 * 4 * 3456 * 4 + 3456 * 4), 3 * 4 * 4 * 3456)
    nbytes, _ = dlrm_dcnv2.kernel(m, "sparse_update", batch)
    live_row = 4 * (2 * 128 + 6) + 2 * 128 * 4
    rows = sum(m[f"rows_{t}"] for t in m["tables"])
    assert nbytes == 27 * live_row + (rows - 27) * 4
    assert dlrm_dcnv2.kernel(m, "field_attention_bwd", batch) is None


def test_k10_reader_finds_its_kernel_or_nothing():
    from harness.cells import load_file
    from harness.runner import Run
    from harness.trace import Trace

    cell = _cell()
    reader = load_file(os.path.join(BENCH, "metrics", "dcn_cross_roofline.train.py"), "k10")
    b = 16384
    ids = {t: torch.zeros((b, h), dtype=torch.int32) for t, h in zip(cell.m["tables"],
                                                                   cell.m["hotness"])}
    mask = {t: torch.ones(v.shape) for t, v in ids.items()}
    batch = {"ids": ids, "mask": mask}
    name = "void (anonymous namespace)::dcn_cross_bwd_kernel<4>(float const*)"
    events = [{"ph": "X", "cat": "kernel", "name": name, "ts": 10.0 + 500 * i, "dur": 400.0}
              for i in range(3)]
    run = Run(cell.m, "train", cell.counts, Trace(events), [batch], 0.04, 1)
    least = cell.counts.kernel(cell.m, "dcn_cross", batch)[0] / 3.35e12
    assert abs(reader.read(run) - 100 * least / 1.2e-3) < 1e-9
    other = [dict(e, name="void fold_mean_group_kernel(Group)") for e in events]
    assert reader.read(Run(cell.m, "train", cell.counts, Trace(other), [batch], 0.04, 1)) is None
