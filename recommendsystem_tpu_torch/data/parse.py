"""Raw feasigns -> model batch.

Counterpart of ``pad_ids`` in ``recommendsystem_tpu/data/parse.py`` (the
record readers come with the data-plane slice of the port).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..embedding.engine import IdBatch


def pad_ids(values: List[List[int]], max_len: int, hash_fn) -> IdBatch:
    """Ragged int64 feasigns -> (B, max_len) int32 rows + float mask, as CPU
    tensors.  Overflow ids beyond max_len are dropped (static-shape
    contract); padding carries id 0."""
    b = len(values)
    rows = np.zeros((b, max_len), np.int32)
    mask = np.zeros((b, max_len), np.float32)
    for i, vals in enumerate(values):
        vals = vals[:max_len]
        if vals:
            rows[i, :len(vals)] = hash_fn(np.asarray(vals, np.int64))
            mask[i, :len(vals)] = 1.0
    return IdBatch(rows=torch.from_numpy(rows), mask=torch.from_numpy(mask))
