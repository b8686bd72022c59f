"""The FLOP and byte counts against hand counts at tiny shapes, and the
dense parameter counts against the program's models."""

from __future__ import annotations

import torch

from conftest import tiny_cell


def _batch(ids, mask):
    return {"ids": ids, "mask": mask}


def test_autoint_flops_per_example_by_hand():
    from counts import autoint

    m = {"slots": ["a", "b"], "dim": 4, "mlp": [3],
         "interact": {"layer_num": 1, "unit_num": 2, "head_num": 1, "use_res": True}}
    # projections 4 x 2 F D U = 4 x 2 x 2 x 4 x 2; scores and sum 2 x 2 F F U;
    # MLP 2 x (F D) x 3; output unit 2 x (3 + F U)
    want = 4 * 2 * 2 * 4 * 2 + 2 * 2 * 2 * 2 * 2 + 2 * 8 * 3 + 2 * (3 + 4)
    assert autoint.flops_per_example(m) == want


def test_sparse_adam_bytes_by_hand():
    from counts import autoint

    m = {"slots": ["a", "b"], "dim": 2, "bucket_size": 10, "ids_per_column": 2,
         "interact": {"layer_num": 1, "unit_num": 2, "head_num": 1, "use_res": True},
         "mlp": [2]}
    ids = {"a": torch.tensor([[1, 1], [2, 0]], dtype=torch.int32),
           "b": torch.tensor([[3, 0], [3, 4]], dtype=torch.int32)}
    mask = {"a": torch.tensor([[1.0, 1.0], [1.0, 0.0]]), "b": torch.tensor([[1.0, 0.0], [1.0, 1.0]])}
    nbytes, ops = autoint.kernel(m, "sparse_update", _batch(ids, mask))
    # table a: rows {1, 2} live, table b: rows {3, 4}; a live row moves
    # 4 (2 (D + 1) + 4) + 2 D (4 + 8) bytes, a dead one 4
    live_row = 4 * (2 * 3 + 4) + 2 * 2 * 12
    assert nbytes == 2 * (2 * live_row + 8 * 4)
    assert ops == 4 * 2 * 14


def test_fold_mean_and_din_bytes_by_hand():
    from harness import peaks

    assert peaks.fold_mean(n_ids=6, n_live=4, uniq=3, d=2, outputs=2) == (
        6 * 4 * 2 + 3 * 2 * 4 + 2 * 2 * 4, 2 * 4 * 2)
    nbytes, ops = peaks.din_pool_gather(b=1, t=2, h=1, live=1, uniq=1, weights=5)
    assert nbytes == 4 * (2 * 2 + 1) + 4 * 1 + 1 * 1 * 4 + 4 * 5
    assert ops == 2 * 1 * (16 + 16 + 1) + 2 * (2 * 16)


def test_least_seconds_takes_the_larger_bound():
    from harness import peaks

    assert peaks.least_seconds(3.35e12, 0) == 1.0
    assert peaks.least_seconds(0, 67e12) == 1.0


def test_dense_params_match_the_programs_models():
    from counts import autoint, staytime
    from recommendsystem_tpu_torch.models.base import create_model
    from recommendsystem_tpu_torch.models.staytime import StaytimeConfig

    a = create_model("autoint", bucket_size=64, device="cpu")
    s = create_model("staytime", cfg=StaytimeConfig(bucket_size=64), device="cpu")
    assert autoint.dense_params(tiny_cell("autoint.train").m) == sum(
        p.numel() for p in a.module.parameters())
    assert staytime.dense_params(tiny_cell("staytime.train").m) == sum(
        p.numel() for p in s.module.parameters())


def test_step_counts_grow_with_the_batch():
    from harness.traffic import Traffic

    cell = tiny_cell("staytime.train")
    gen = Traffic(cell.model, cell.m, cell.traffic, 5, "cpu")
    small, large = gen.batch(0, 16), gen.batch(0, 64)
    f_small, b_small = cell.counts.step(cell.m, "train", small)
    f_large, b_large = cell.counts.step(cell.m, "train", large)
    assert f_large > 3 * f_small and b_large > b_small
    f_pred, _ = cell.counts.step(cell.m, "predict", large)
    assert f_large == 3 * f_pred
