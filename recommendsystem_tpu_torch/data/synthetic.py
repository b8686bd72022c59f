"""Synthetic CTR data for tests and the chip smoke run.

Counterpart of ``recommendsystem_tpu/data/synthetic.py``: the same numpy
draws in the same column order, so for one seed both packages see
byte-identical batches.  The staytime and distillation label branches come
with the models that need them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..embedding.engine import IdBatch
from ..models.base import ModelBundle


def synthetic_batch(bundle: ModelBundle, batch_size: int, seed: int = 0,
                    ids_per_feature=5) -> Tuple[
                        Dict[str, IdBatch], Optional[dict],
                        Dict[str, torch.Tensor], torch.Tensor]:
    """Returns (batch, dense_inputs, labels, sample_weight) as tensors on
    the bundle's device.

    A hidden per-sample scalar "engagement" drives both which ids appear and
    the labels.  ``ids_per_feature``: padded width of mean-combined columns
    — an int for all columns, or a {column_key: width} dict (unlisted
    columns default to 1)."""
    rng = np.random.default_rng(seed)
    engagement = rng.uniform(0.0, 1.0, size=(batch_size,))

    dev = bundle.device
    batch: Dict[str, IdBatch] = {}
    for key, col in bundle.embedding.columns.items():
        bucket = col.categorical_column.bucket_size
        if col.is_sequence:
            length = col.seq_max_len
        elif isinstance(ids_per_feature, dict):
            length = ids_per_feature.get(key, 1)
        else:
            length = ids_per_feature
        # high-engagement users draw from the low end of the id space
        centers = (engagement * 0.5 * bucket).astype(np.int64)
        noise = rng.integers(0, max(bucket // 2, 1), size=(batch_size, length))
        rows = ((centers[:, None] + noise) % bucket).astype(np.int32)
        lens = rng.integers(1, length + 1, size=(batch_size,))
        mask = (np.arange(length)[None, :] < lens[:, None]).astype(np.float32)
        # masked positions carry id 0, as the parse path zero-fills
        rows = rows * mask.astype(np.int32)
        batch[key] = IdBatch(rows=torch.from_numpy(rows).to(dev),
                             mask=torch.from_numpy(mask).to(dev))

    dense_inputs = None
    if bundle.dense_input_keys:
        dense_inputs = {
            k: torch.from_numpy(rng.integers(0, 2, size=(batch_size, 1))
                                .astype(np.float32)).to(dev)
            for k in bundle.dense_input_keys}

    labels: Dict[str, torch.Tensor] = {}
    p = 1.0 / (1.0 + np.exp(-(engagement * 4.0 - 2.0)))       # planted CTR signal
    click = (rng.uniform(size=batch_size) < p).astype(np.float32)[:, None]
    weight = np.ones((batch_size, 1), np.float32)
    for task in bundle.tasks:
        # fresh correlated binary label per head
        flip = rng.uniform(size=(batch_size, 1)) < 0.15
        labels[task] = torch.from_numpy(
            np.where(flip, 1.0 - click, click).astype(np.float32)).to(dev)
    return batch, dense_inputs, labels, torch.from_numpy(weight).to(dev)
