"""Per-user GAUC engine + mixed-score fusion (``gaussain/gaussian_model_utils.py``).

- ``cal_mixed_score``: product fusion over the 9 production score heads,
  ``((b + c·s)^a) / 10^a`` per head (``gaussian_model_utils.py:187-211``).
- ``group_auc``: per-user AUC weighted by impressions, skipping
  single-label users (``:242-280``); the staytime head uses the
  inversion-pair consistency AUC instead of ROC (``:342-345``).
- ``reward``: Σ weighted GAUC deltas vs base with hard validity gates that
  reject a parameterization outright (return -1) when protected heads
  regress (``:455-528``).

Re-design: pandas/NumPy vectorized grouping (sort-by-user + segment
reduction) and a multiprocessing bucket map replacing the 600-executor Spark
map (``gaussian_process.py:279-296``).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from multiprocessing import Pool
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .metrics import binary_label_auc, float_label_auc

GAUC_MIN_DATA_SIZE = 20    # gaussian_model_utils.py:116
GAUC_MAX_DATA_SIZE = 200   # gaussian_model_utils.py:117


# Default head configuration mirroring the reference's bound_x table
# (gaussian_model_utils.py:28-101): per head [a, b, c] bounds and the tuned
# production params recorded in BASELINE.md.
def default_bound_x() -> Dict[str, dict]:
    b_fix, c_lower, c_upper = 1, 1, 20
    c_lower_v2, c_upper_v2 = 500, 1000
    inter_lo, inter_hi = 1, 10
    return {
        "finish": {"upper": [15, b_fix, c_upper], "lower": [1, b_fix, c_lower],
                   "param": [11.0036, 1, 8.5071], "coin_param": [12.4821, 1.0, 10.7172],
                   "gauc": 0.0, "spearman": False},
        "staytime": {"upper": [10, b_fix, 10], "lower": [1, b_fix, c_lower],
                     "param": [7.3117, 1, 10], "coin_param": [3.1975, 1.0, 10],
                     "gauc": 0.0, "spearman": True},
        "skip": {"upper": [-7, b_fix, c_upper], "lower": [-17, b_fix, c_lower],
                 "param": [-8.551, 1, 8.1329], "coin_param": [-12.0919, 1.0, 5.6724],
                 "gauc": 0.0, "spearman": False},
        "like": {"upper": [inter_hi, b_fix, c_upper], "lower": [inter_lo, b_fix, c_lower],
                 "param": [5.5916, 1, 14.8067], "coin_param": [6.0, 1.0, 9.3455],
                 "gauc": 0.0, "spearman": False},
        "commentshow": {"upper": [inter_hi, b_fix, c_upper], "lower": [inter_lo, b_fix, c_lower],
                        "param": [5.6182, 1, 4.885], "coin_param": [6.0, 1.0, 4.12],
                        "gauc": 0.0, "spearman": False},
        "share": {"upper": [inter_hi, b_fix, c_upper_v2], "lower": [inter_lo, b_fix, c_lower_v2],
                  "param": [2.1347, 1, 940.9091], "coin_param": [2.6, 1.0, 926.7052],
                  "gauc": 0.0, "spearman": False},
        "comment": {"upper": [inter_hi, b_fix, c_upper_v2], "lower": [inter_lo, b_fix, c_lower_v2],
                    "param": [2.4477, 1, 854.663], "coin_param": [3.0, 1.0, 771.6298],
                    "gauc": 0.0, "spearman": False},
        "follow": {"upper": [inter_hi, b_fix, c_upper], "lower": [inter_lo, b_fix, c_lower],
                   "param": [2.1044, 1, 9.4131], "coin_param": [3.1968, 1.0, 9.6284],
                   "gauc": 0.0, "spearman": False},
        "head": {"upper": [inter_hi, b_fix, c_upper], "lower": [inter_lo, b_fix, c_lower],
                 "param": [2.3391, 1, 11.6726], "coin_param": [2.3816, 1.0, 8.6762],
                 "gauc": 0.0, "spearman": False},
    }


def cal_mixed_score(ind_var: Dict[str, Sequence[float]],
                    scores: Dict[str, np.ndarray]) -> np.ndarray:
    mixed = 1.0
    for model_name, (a, b, c) in ind_var.items():
        s = np.asarray(scores[model_name], dtype=np.float64)
        mixed = mixed * (np.power(b + c * s, a) / np.power(10.0, a))
    return np.asarray(mixed)


def filter_user_group_sizes(user_ids: np.ndarray,
                            min_size: int = GAUC_MIN_DATA_SIZE,
                            max_size: int = GAUC_MAX_DATA_SIZE) -> np.ndarray:
    """Boolean keep-mask: per-user impression count in [min, max]
    (``gaussian_process.py:423``)."""
    _, inverse, counts = np.unique(user_ids, return_inverse=True,
                                   return_counts=True)
    c = counts[inverse]
    return (c >= min_size) & (c <= max_size)


def group_auc(labels: np.ndarray, preds: np.ndarray, user_ids: np.ndarray,
              is_spearman: bool = False) -> Tuple[float, int]:
    """Returns (Σ auc_u · n_u, Σ n_u) over users with >1 distinct label."""
    if len(user_ids) != len(labels):
        raise ValueError("impression id num should equal to the sample num,"
                         "impression id num is {0}".format(len(user_ids)))
    order = np.argsort(user_ids, kind="stable")
    labels, preds, user_ids = labels[order], preds[order], user_ids[order]
    boundaries = np.nonzero(np.concatenate([[True], user_ids[1:] != user_ids[:-1]]))[0]
    boundaries = np.append(boundaries, len(user_ids))

    total_auc = 0.0
    impression_total = 0
    for s, e in zip(boundaries[:-1], boundaries[1:]):
        y = labels[s:e]
        if np.all(y == y[0]):          # single-label group: skipped
            continue
        p = preds[s:e]
        auc = float_label_auc(p, y) if is_spearman else binary_label_auc(p, y)
        total_auc += auc * (e - s)
        impression_total += e - s
    return total_auc, impression_total


def _bucket_worker(args):
    params, scores, labels, users, head_flags = args
    mixed = cal_mixed_score(params, scores)
    out = {}
    for head, spearman in head_flags.items():
        out[head] = group_auc(labels[head], mixed, users, is_spearman=spearman)
    return out


@dataclasses.dataclass
class GaucEngine:
    """Bucketed GAUC evaluation: hash users into buckets, map in parallel,
    reduce the per-head (numerator, denominator) pairs."""

    scores: Dict[str, np.ndarray]
    labels: Dict[str, np.ndarray]
    user_ids: np.ndarray
    bound_x: Dict[str, dict]
    num_buckets: int = 16
    processes: Optional[int] = None

    def __post_init__(self):
        bucket = np.abs(
            np.array([hash(u) for u in self.user_ids]) % self.num_buckets)
        self._bucket_args = []
        head_flags = {h: self.bound_x[h].get("spearman", False)
                      for h in self.bound_x}
        for bidx in range(self.num_buckets):
            m = bucket == bidx
            if not m.any():
                continue
            self._bucket_args.append((
                {h: self.scores[h][m] for h in self.scores},
                {h: self.labels[h][m] for h in self.labels},
                self.user_ids[m], head_flags))

    def eval_params(self, params: Dict[str, Sequence[float]],
                    parallel: bool = False) -> Dict[str, float]:
        args = [(params, s, l, u, hf) for s, l, u, hf in self._bucket_args]
        if parallel and len(args) > 1:
            with Pool(self.processes) as pool:
                results = pool.map(_bucket_worker, args)
        else:
            results = [_bucket_worker(a) for a in args]
        num: Dict[str, float] = defaultdict(float)
        den: Dict[str, int] = defaultdict(int)
        for r in results:
            for head, (n, d) in r.items():
                num[head] += n
                den[head] += d
        out = {}
        for head in num:
            g = num[head] / den[head] if den[head] else 0.0
            if head == "skip":
                g = 1.0 - g        # lower skip ranking is better (utils:483)
            out[head] = g
        return out

    def mark_base(self, params: Dict[str, Sequence[float]],
                  parallel: bool = False) -> Dict[str, float]:
        gaucs = self.eval_params(params, parallel=parallel)
        for head, g in gaucs.items():
            self.bound_x[head]["gauc"] = g
        return gaucs

    def reward(self, params: Dict[str, Sequence[float]],
               switch: bool = False, is_coin_user: bool = False,
               parallel: bool = False) -> Tuple[float, str]:
        """gaussian_model_utils.py:455-528 — hard gates + weighted deltas."""
        gaucs = self.eval_params(params, parallel=parallel)
        reward = 0.0
        detail = ""
        for head, g in gaucs.items():
            base = self.bound_x[head]["gauc"]
            tmp = g - base
            if is_coin_user:
                if head in ("finish", "staytime", "commentshow", "head") \
                        and g < base and not switch:
                    return -1.0, f"{head} not valid:{g}:{g - base}"
                if head in ("share", "comment", "follow", "like") \
                        and g < base - 0.1 and not switch:
                    return -1.0, f"{head} not valid:{g}:{g - base}"
                if head in ("staytime", "commentshow"):
                    tmp *= 100
                if head in ("finish", "head"):
                    tmp *= 10
            else:
                if head in ("finish", "staytime", "commentshow", "like") \
                        and g < base and not switch:
                    return -1.0, f"{head} not valid:{g}:{g - base}"
                if head in ("share", "comment", "follow", "head") \
                        and g < base - 0.1 and not switch:
                    return -1.0, f"{head} not valid:{g}:{g - base}"
                if head in ("staytime", "finish"):
                    tmp *= 100
                if head in ("commentshow", "like"):
                    tmp *= 10
            reward += tmp
            detail += f"{head}:{g}diff:{g - base},"
        detail += f"reward:{reward}"
        return reward, detail


@dataclasses.dataclass
class DurationBucketedGaucEngine:
    """reward_v2 (``gaussian_model_utils.py:378-453``): the sample table is
    split into two video-duration cohorts; GAUCs are evaluated per part
    against per-part bases (``gauc_0`` / ``gauc_1``); finish is boosted 100x
    in the long-duration part and staytime 100x in the short part; a lower
    protected set (share/commentshow/comment at -0.01, like/follow/head at
    -0.01 vs global base) gates invalid params to -1."""

    scores: Dict[str, np.ndarray]
    labels: Dict[str, np.ndarray]
    user_ids: np.ndarray
    duration_bucket: np.ndarray            # (N,) int {0, 1}
    bound_x: Dict[str, dict]
    num_buckets: int = 16

    def __post_init__(self):
        self._parts = []
        for part in (0, 1):
            m = self.duration_bucket == part
            self._parts.append(GaucEngine(
                scores={h: self.scores[h][m] for h in self.scores},
                labels={h: self.labels[h][m] for h in self.labels},
                user_ids=self.user_ids[m], bound_x=self.bound_x,
                num_buckets=self.num_buckets))

    def mark_base(self, params, parallel: bool = False):
        for part, eng in enumerate(self._parts):
            gaucs = eng.eval_params(params, parallel=parallel)
            for head, g in gaucs.items():
                self.bound_x[head][f"gauc_{part}"] = g

    def reward_v2(self, params, switch: bool = False,
                  parallel: bool = False) -> Tuple[float, str]:
        reward = 0.0
        detail = ""
        for part, eng in enumerate(self._parts):
            base_key = f"gauc_{part}"
            gaucs = eng.eval_params(params, parallel=parallel)
            for head, g in gaucs.items():
                base = self.bound_x[head].get(base_key, 0.0)
                if head in ("share", "commentshow", "comment")                         and g < base - 0.01 and not switch:
                    return -1.0, f"part{part}:{head} not valid:{g}:{g - base}"
                if head in ("like", "follow", "head")                         and g < self.bound_x[head].get("gauc", 0.0) - 0.01                         and not switch:
                    return -1.0, f"part{part}:{head} not valid:{g}:{g - base}"
                if head in ("finish", "staytime") and g < base:
                    return -1.0, f"part{part}:{head} not valid:{g}:{g - base}"
                tmp = g - base
                if (head == "finish" and part == 1) or                         (head == "staytime" and part == 0):
                    reward += 100 * tmp
                else:
                    reward += tmp
                detail += f"{part}:{head}:{g} diff: {g - base},"
        detail += f"reward:{reward}"
        return reward, detail
