"""Streaming per-user GAUC on the device, inside the eval loop.

Counterpart of ``recommendsystem_tpu/train/streaming_gauc.py``.  The
reference computes GAUC offline (dump predictions, group by user, per-user
AUC weighted by impressions, ``gaussian_model_utils.py:242-280``; here
``search/gauc.py``); this keeps it on the device as additive state:

- users hash into ``num_buckets`` buckets (optionally through a 32-bit
  mixer, so that sequential ids spread);
- each bucket keeps positive and negative histograms over ``num_bins``
  prediction bins;
- per-bucket AUC by the rank sum over the histogram (ties inside one bin
  credit 0.5), weighted by the bucket's impressions, single-class buckets
  skipped (``group_auc``'s weighting).

With ``hash_ids=False``, ids below ``num_buckets`` and predictions in
distinct bins, this equals ``search.gauc.group_auc`` to rounding.

Integer semantics are the JAX package's (x64 off): an id counts by its low
32 bits (a negative id wraps), computed in int64 with a mask after each
multiply, since PyTorch has no uint32 shift on the CPU.  A prediction's bin
saturates as XLA's float-to-int32 conversion does: above the range (+inf
included) the last bin, below it (-inf included) bin 0, NaN bin 0; the
clamp is taken in float before the cast, so the CPU and the card agree.
Updates return new tensors; the histograms take their counts by
``index_add`` (atomics on the card: with fractional weights the sums agree
with another order only to rounding).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), with no int64 overflow:
    c is split in 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer on the ids' low 32 bits, as int64 values in
    [0, 2**32): decorrelates sequential user ids before the bucket mod."""
    x = x.to(torch.int64) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _buckets(user_ids: torch.Tensor, num_buckets: int, hash_ids: bool) -> torch.Tensor:
    u = user_ids.reshape(-1)
    u = mix32(u) if hash_ids else u.to(torch.int64) & _MASK32
    return u % num_buckets


def _bin(x: torch.Tensor, lo: float, hi: float, n: int) -> torch.Tensor:
    v = (x - lo) * (n / (hi - lo))
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
    return torch.clamp(v, 0.0, float(n - 1)).to(torch.int64)


def _weights(y: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.ones_like(y) if weight is None else \
        torch.broadcast_to(weight.reshape(-1), y.shape).float()


@dataclasses.dataclass(frozen=True)
class StreamingGauc:
    """Functional (init / update / compute) like ``train.metrics.Metric``,
    but ``update`` also takes the per-example user ids."""

    num_buckets: int = 4096
    num_bins: int = 256
    # predictions bin uniformly over [lo, hi); values outside clip into the
    # edge bins (ties there), and state["oor"] counts them
    lo: float = 0.0
    hi: float = 1.0
    hash_ids: bool = True

    def init(self, device):
        shape = (self.num_buckets, self.num_bins)
        return {"pos": torch.zeros(shape, dtype=torch.float32, device=device),
                "neg": torch.zeros(shape, dtype=torch.float32, device=device),
                "oor": torch.zeros((), dtype=torch.float32, device=device)}

    def bucket(self, user_ids: torch.Tensor) -> torch.Tensor:
        return _buckets(user_ids, self.num_buckets, self.hash_ids)

    def update(self, state, y_true: torch.Tensor, y_pred: torch.Tensor,
               user_ids: torch.Tensor, weight: Optional[torch.Tensor] = None):
        y = y_true.reshape(-1).float()
        p = y_pred.reshape(-1).float()
        flat = self.bucket(user_ids) * self.num_bins + _bin(p, self.lo, self.hi, self.num_bins)
        w = _weights(y, weight)
        oor = torch.sum(((p < self.lo) | (p >= self.hi)).float())
        shape = state["pos"].shape
        return {"pos": state["pos"].reshape(-1).index_add(0, flat, w * y).reshape(shape),
                "neg": state["neg"].reshape(-1).index_add(0, flat, w * (1.0 - y)).reshape(shape),
                "oor": state["oor"] + oor}

    def compute(self, state) -> torch.Tensor:
        """Impression-weighted mean of per-bucket AUCs (single-class buckets
        carry zero weight)."""
        total, denom = self.compute_parts(state)
        return total / torch.clamp(denom, min=1e-12)

    def compute_parts(self, state):
        """(sum auc_u * n_u, sum n_u): the pair ``group_auc`` returns."""
        pos, neg = state["pos"], state["neg"]
        neg_below = torch.cumsum(neg, dim=1) - neg
        ranksum = torch.sum(pos * (neg_below + 0.5 * neg), dim=1)   # (U,)
        p_tot = torch.sum(pos, dim=1)
        n_tot = torch.sum(neg, dim=1)
        auc = ranksum / torch.clamp(p_tot * n_tot, min=1e-12)
        w = torch.where((p_tot > 0) & (n_tot > 0), p_tot + n_tot, torch.zeros_like(p_tot))
        return torch.sum(auc * w), torch.sum(w)


@dataclasses.dataclass(frozen=True)
class StreamingSpearmanGauc:
    """Streaming continuous-label "consistency AUC" (``pso/util.py:19-56``,
    ``float_label_auc``): per user bucket, the share of concordant (pred,
    label) pairs, from a per-bucket 2-D (pred bin x label bin) histogram
    whose concordant pair count is a 2-D prefix sum.  Pairs tied in
    prediction bin take 0.5 credit.  Weighted as ``group_auc(...,
    is_spearman=True)``: value x impressions, single-label buckets skipped."""

    num_buckets: int = 1024
    pred_bins: int = 32
    label_bins: int = 32
    pred_lo: float = 0.0
    pred_hi: float = 1.0
    label_lo: float = 0.0
    label_hi: float = 1.0
    hash_ids: bool = True

    def init(self, device):
        return {"hist": torch.zeros((self.num_buckets, self.pred_bins, self.label_bins),
                                    dtype=torch.float32, device=device)}

    def update(self, state, y_true: torch.Tensor, y_pred: torch.Tensor,
               user_ids: torch.Tensor, weight: Optional[torch.Tensor] = None):
        y = y_true.reshape(-1).float()
        p = y_pred.reshape(-1).float()
        u = _buckets(user_ids, self.num_buckets, self.hash_ids)
        pb = _bin(p, self.pred_lo, self.pred_hi, self.pred_bins)
        lb = _bin(y, self.label_lo, self.label_hi, self.label_bins)
        flat = (u * self.pred_bins + pb) * self.label_bins + lb
        h = state["hist"]
        return {"hist": h.reshape(-1).index_add(0, flat, _weights(y, weight)).reshape(h.shape)}

    def compute_parts(self, state):
        h = state["hist"]                              # (U, P, L)
        # concordant pairs: one element strictly below in both pred and
        # label bin, by exclusive 2-D prefix sums
        cp = torch.cumsum(h, dim=1)
        cpl = torch.cumsum(cp, dim=2)
        below_both = cpl - cp - torch.cumsum(h, dim=2) + h
        concordant = torch.sum(h * below_both, dim=(1, 2))
        # pairs tied in pred bin with differing label bins: 0.5 credit
        tied_pred_diff_label = (torch.sum(torch.sum(h, dim=2) ** 2, dim=1)
                                - torch.sum(h * h, dim=(1, 2))) / 2.0
        concordant = concordant + 0.5 * tied_pred_diff_label

        n = torch.sum(h, dim=(1, 2))
        total_pairs = n * (n - 1) / 2.0
        value = concordant / torch.clamp(total_pairs, min=1e-12)
        label_tot = torch.sum(h, dim=1)                # (U, L)
        multi_label = torch.sum((label_tot > 0).to(torch.int32), dim=1) > 1
        w = torch.where(multi_label & (n > 1), n, torch.zeros_like(n))
        return torch.sum(value * w), torch.sum(w)

    def compute(self, state) -> torch.Tensor:
        total, denom = self.compute_parts(state)
        return total / torch.clamp(denom, min=1e-12)
