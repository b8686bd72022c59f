"""Staytime label engineering, from raw watch durations.

Counterpart of ``recommendsystem_tpu/data/staytime_labels.py`` (the
reference's ``staytime/parse.py:16-71``), the same numpy code.  From raw
``watch_duration`` (ms):

- shortplay label: wt > 7000 ms; longplay label: wt > 18000 ms;
- staytime label: wt/1000 clipped at 160 s, turned into a Gaussian-smoothed
  (sigma=4) soft distribution over the 400 half-second bins, scaled by the
  bin width, with the true wt concatenated as a 401st column;
- sample_weight: 5x for ``video_homepage_landing`` traffic.

Plain numpy on the host; the synthetic batches hand the labels to the card
as tensors.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Tuple

import numpy as np

MULTICLASS_NUM = 400
LEFT = -19.0
RIGHT = 180.5
WIDTH = (RIGHT - LEFT) / (MULTICLASS_NUM - 1)
SIGMA = 4.0
BIN_LIST = np.arange(MULTICLASS_NUM, dtype=np.float32) * 0.5 + LEFT

SHORT_FIELD_MS = 7000
LONG_FIELD_MS = 18000
WT_CLIP_S = 160.0
HOMEPAGE_PATTERN = re.compile(r".*video_homepage_landing.*")


def staytime_labels(watch_duration_ms: np.ndarray,
                    extra_info: np.ndarray | None = None
                    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Returns ({staytime: (B, 401), shortplay: (B, 1), longplay: (B, 1)},
    sample_weight (B, 1))."""
    wt_ms = np.asarray(watch_duration_ms, dtype=np.int64)
    short_label = (wt_ms > SHORT_FIELD_MS).astype(np.float32)[:, None]
    long_label = (wt_ms > LONG_FIELD_MS).astype(np.float32)[:, None]

    wt = wt_ms.astype(np.float32) / 1000.0
    wt = np.minimum(wt, WT_CLIP_S)[:, None]                       # (B, 1)

    dist = BIN_LIST[None, :] - wt                                 # (B, 400)
    abs_square_dist = np.square(np.abs(dist))
    div_num = math.sqrt(2 * math.pi) * SIGMA
    label = np.exp(abs_square_dist / (-2 * SIGMA ** 2)) / div_num
    label = label * WIDTH
    staytime_label = np.concatenate([label, wt], axis=-1).astype(np.float32)

    if extra_info is not None:
        is_hp = np.array([bool(HOMEPAGE_PATTERN.match(str(s))) for s in extra_info])
        sample_weight = np.where(is_hp[:, None], 5.0, 1.0).astype(np.float32)
    else:
        sample_weight = np.ones_like(wt, dtype=np.float32)

    return ({"staytime": staytime_label, "shortplay": short_label,
             "longplay": long_label}, sample_weight)
