"""The H100's published peaks, the least time of an amount of work, and the
bytes and operations of the kernels whose roofline share the benchmark
reports.

Copied from ``chip_smoke.py`` (lines named at each), with one change: the
live rows come from the ids the benchmark generated (``live_rows``), not
from the program's accumulators.  On a sharded cell a rank's kernel works
on its block of each table's storage (``table_shard``) for the ids of
every rank.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

import torch

# chip_smoke.py:277-278; NVIDIA H100 SXM data sheet, dense rates at 700 W
H100_BYTES_PER_S = 3.35e12          # HBM3
H100_F32_OPS_PER_S = 67e12          # float32 outside the tensor cores


def least_seconds(nbytes: float, ops: float) -> float:
    """The larger of bytes over the memory peak and operations over the
    float32 peak (chip_smoke.py:400-403, ``bound``, in seconds)."""
    return max(nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S)


def storage_rows(rows: int, dim: int, world: int) -> int:
    """The rows the program stores a table of ``rows`` x ``dim`` in on
    ``world`` ranks, where the table is a storage of its own
    (``recommendsystem_tpu_torch/embedding/engine.py``, ``stride_of``
    with ``packed``): padded to ``world`` times the least common multiple
    of the 128-lane gather and scatter packings (128 // dim and
    128 // (dim + 1) rows), or to a multiple of ``world``
    (``pad_bucket``) where a row and its count do not fit 128 lanes.
    autoint on 4 ranks: 265,216 rows for 265,000."""
    if dim + 1 > 128:
        unit = world
    else:
        unit = world * math.lcm(max(1, 128 // dim), max(1, 128 // (dim + 1)))
    return -(-rows // unit) * unit


def table_shard(rows: int, dim: int,
                shard: Optional[Tuple[int, int]]) -> Tuple[int, int]:
    """(first row, rows) of the block of a table of ``rows`` x ``dim`` that
    rank ``shard[0]`` of ``shard[1]`` holds: its storage
    (``storage_rows``) split over the ranks in equal contiguous blocks, as
    the program splits it (``rows_per_shard``); the last block's tail is
    padding that no id reaches.  The whole table, unpadded, without a
    shard."""
    if shard is None:
        return 0, rows
    rank, world = shard
    block = storage_rows(rows, dim, world) // world
    return rank * block, block


def live_rows(parts: Iterable[Tuple[torch.Tensor, torch.Tensor]],
              block: Optional[Tuple[int, int]] = None) -> int:
    """The distinct rows that live ids reach over ``parts`` ((ids, mask)
    of each column that reads one table); with ``block`` (first row,
    rows; ``table_shard``), only those in it."""
    flat = [ids.reshape(-1)[mask.reshape(-1) > 0] for ids, mask in parts]
    uniq = torch.unique(torch.cat(flat))
    if block is None:
        return int(uniq.numel())
    lo, n = block
    return int(((uniq >= lo) & (uniq < lo + n)).sum())


def fold_mean(n_ids: int, n_live: int, uniq: int, d: int, outputs: int):
    """K1 (chip_smoke.py:441-443): ids and mask read once, each distinct
    row once, the (C B, D) sums written; one multiply-add a live id and
    lane."""
    return n_ids * 4 + n_ids * 4 + uniq * d * 4 + outputs * d * 4, 2 * n_live * d


def field_attention_bwd(h: int, dh: int, f: int, b: int, es: int = 4):
    """K5b (chip_smoke.py:586-589): q, k, v, o, do and lse read once, dq,
    dk, dv written once; per (head, query, key, sample) the scores, dp and
    the dq, dk, dv terms, the exponential and the softmax-gradient
    terms."""
    return (6 * es + 8) * h * dh * f * b + 4 * h * f * b, (10 * dh + 5) * h * f * f * b


def sparse_adam(live: int, rows: int, d: int, sw: int = 4, sm: int = 4):
    """K8 over one storage (chip_smoke.py:1158-1171): a live row reads acc
    (D + 1), w, m, v, t and show and writes them all; a row with count 0
    reads its count."""
    return (live * (4 * (2 * (d + 1) + 4) + 2 * d * (sw + 2 * sm)) + (rows - live) * 4,
            live * d * 14)


def sparse_adagrad(live: int, rows: int, d: int, sw: int = 4):
    """K9 over one storage (chip_smoke.py:1326-1340): a live row reads G
    and its count and writes them back zero, reads and writes w, g2sum and
    show; a row with count 0 reads its count."""
    return live * (4 * (2 * d + 6) + 2 * d * sw) + (rows - live) * 4, live * (5 * d + 3)


def din_ops(positions: int, b: int, h: int) -> int:
    """Multiply-adds x 2 of the float32 DIN pool, folded form
    (chip_smoke.py:1527-1535)."""
    return 2 * positions * (h * 16 + 16 + h) + 2 * b * (2 * h * 16)


def din_pool_gather(b: int, t: int, h: int, live: int, uniq: int, weights: int,
                    es: int = 4, table_es: int = 4):
    """K7 gathering its facts (chip_smoke.py:1654-1659): ids, mask, query
    and output once, each distinct row's H lanes once, the scorer once;
    only a live position needs its score."""
    return (4 * (2 * b * t + b * h) + es * b * h + uniq * h * table_es + es * weights,
            din_ops(live, b, h))
