"""Offline AUC metrics — vectorized NumPy re-designs of ``pso/util.py``.

- ``binary_label_auc``: inversion-count ROC-AUC (``util.py:5-16``): sort by
  prediction descending (stable), count (positive, negative) pairs where the
  positive outranks the negative; ties resolved by sort order, exactly as the
  reference's loop does.
- ``float_label_auc``: "consistency AUC" for continuous labels
  (``util.py:19-56``): 1 - normalized inversion count of the label sequence
  ordered by prediction descending, counting strict inversions only — here
  via an O(n log n) numpy merge instead of the reference's recursive Python
  merge sort.
"""

from __future__ import annotations

import numpy as np


def binary_label_auc(preds, labels) -> float:
    preds = np.asarray(preds, dtype=np.float64)
    labels = np.asarray(labels)
    assert len(preds) == len(labels)
    pos = int(np.sum(labels))
    neg = len(labels) - pos
    if pos == len(labels) or pos == 0:
        return 0.0     # reference returns a degenerate value here (util.py:8)
    order = np.argsort(-preds, kind="stable")
    sorted_labels = labels[order]
    inv = np.cumsum(sorted_labels)
    sum_inv = float(np.sum(inv[sorted_labels == 0]))
    return round(sum_inv / pos / neg, 5)


def _count_inversions(a: np.ndarray) -> int:
    """Strict inversions (a[i] > a[j], i<j) via iterative numpy merge."""
    a = np.asarray(a, dtype=np.float64)
    n = len(a)
    count = 0
    width = 1
    a = a.copy()
    while width < n:
        out = np.empty_like(a)
        for lo in range(0, n, 2 * width):
            mid = min(lo + width, n)
            hi = min(lo + 2 * width, n)
            left, right = a[lo:mid], a[mid:hi]
            if len(right):
                # for each right element: number of left elements strictly greater
                pos_r = np.searchsorted(left, right, side="right")
                count += int(np.sum(len(left) - pos_r))
            merged = np.concatenate([left, right])
            merged.sort(kind="stable")
            out[lo:hi] = merged
        a = out
        width *= 2
    return count


def float_label_auc(preds, labels) -> float:
    preds = np.asarray(preds, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    assert len(preds) == len(labels)
    n = len(preds)
    if n < 2:
        return 0.0
    order = np.argsort(-preds, kind="stable")
    rank = labels[order]
    inversions = _count_inversions(rank)
    return float(inversions) / (n * (n - 1) / 2)


class Metrics:
    """Reference-compatible namespace (``pso/pso.py:4`` imports ``Metrics``)."""

    binaryIntLabelAuc = staticmethod(binary_label_auc)
    floatLabelAuc = staticmethod(float_label_auc)
