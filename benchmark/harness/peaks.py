"""The H100's published peaks, the least time of an amount of work, and the
bytes and operations of the kernels whose roofline share the benchmark
reports.

Copied from ``chip_smoke.py`` (lines named at each), with one change: the
live rows come from the ids the benchmark generated (``live_rows``), not
from the program's accumulators.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

# chip_smoke.py:277-278; NVIDIA H100 SXM data sheet, dense rates at 700 W
H100_BYTES_PER_S = 3.35e12          # HBM3
H100_F32_OPS_PER_S = 67e12          # float32 outside the tensor cores


def least_seconds(nbytes: float, ops: float) -> float:
    """The larger of bytes over the memory peak and operations over the
    float32 peak (chip_smoke.py:400-403, ``bound``, in seconds)."""
    return max(nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S)


def live_rows(parts: Iterable[Tuple[torch.Tensor, torch.Tensor]]) -> int:
    """The distinct rows that live ids reach over ``parts`` ((ids, mask)
    of each column that reads one table)."""
    flat = [ids.reshape(-1)[mask.reshape(-1) > 0] for ids, mask in parts]
    return int(torch.unique(torch.cat(flat)).numel())


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
