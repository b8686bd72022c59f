"""What the plain references of every configuration share.

Plain float32 PyTorch, written from the published descriptions of the
layers and optimizers.  It imports neither the program under test nor
JAX: the harness hands it the weights and batches it drew itself, and
reads what the program produced only to judge it.

- ``philox4x32_10`` and ``dropout_scale``: the counter-based dropout bits
  of the field attention (Salmon et al., SC'11): for weight (head, query
  fq, key fk, sample b) word ``fk % 4`` of Philox4x32-10 at counter
  ``(sample0 + b, fq, head, fk // 4)`` under the key ``(seed >> 32, seed &
  0xffffffff)``; the weight is kept where the word is at least ``rate *
  2**32`` and scaled by ``1 / (1 - rate)``.  Frozen from the program's plain
  version (``kernels/field_attention.py``), so both sides drop the same
  weights.
- ``gather``: the raw rows of a column, ``table[ids]`` (B, L, D), as a
  leaf whose gradient the update scatters back;
- ``mean_combine``: the masked mean of a column's rows (a row of no live
  id gives zeros);
- ``lazy_adam`` and ``lazy_adagrad``: the per-row optimizers of the sparse
  tables (only rows that a live id reached move; Adam's bias correction
  counts each row's own steps; AdaGrad adds the mean of the row's squared
  gradient to its one accumulator);
- ``Adam``: dense Adam in optax's order of operations;
- ``dense``: ``activation(x @ kernel + bias)``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products with TF32 off (the configurations' precision), or
    on (the control, one step below it)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _mulhilo(a: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xl, xh = x & 0xFFFF, x >> 16
    pl, ph = a * xl, a * xh
    mid = pl + ((ph & 0xFFFF) << 16)
    return (ph >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit counter words."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def dropout_scale(h: int, f: int, b: int, seed: int, rate: float, device,
                  sample0: int = 0) -> torch.Tensor:
    """(h, F, F, B) float32 multipliers of the attention weights (query,
    key) of samples ``sample0 .. sample0 + B``."""
    k0, k1 = seed >> 32, seed & _MASK32
    i64 = dict(dtype=torch.int64, device=device)
    groups = -(-f // 4)
    words = philox4x32_10((torch.arange(sample0, sample0 + b, **i64) & _MASK32).view(1, 1, 1, b),
                          torch.arange(f, **i64).view(1, f, 1, 1),
                          torch.arange(h, **i64).view(h, 1, 1, 1),
                          torch.arange(groups, **i64).view(1, 1, groups, 1), k0, k1)
    bits = torch.stack(words, dim=3).reshape(h, f, 4 * groups, b)[:, :, :f]
    keep = bits >= min(int(rate * (1 << 32)), _MASK32)
    return keep.to(torch.float32) * (1.0 / (1.0 - rate))


def gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``ids`` (B, L) as a fresh leaf (B, L, D) that needs a
    gradient."""
    return table[ids.long()].detach().requires_grad_()


def mean_combine(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, L, D) rows and (B, L) {0, 1} mask -> (B, D) masked mean."""
    total = (rows * mask[..., None]).sum(dim=1)
    return total / mask.sum(dim=1, keepdim=True).clamp(min=1.0)


def scatter_rows(num_rows: int, parts) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (rows, D) gradient sums and (rows, 1) live-id counts of one
    table from ``parts``: (ids (B, L), mask (B, L), grad (B, L, D)) of each
    column that reads it."""
    d = parts[0][2].shape[-1]
    dev = parts[0][2].device
    grad = torch.zeros((num_rows, d), dtype=torch.float32, device=dev)
    count = torch.zeros((num_rows, 1), dtype=torch.float32, device=dev)
    for ids, mask, g in parts:
        live = (mask > 0).reshape(-1)
        flat = ids.reshape(-1).long()[live]
        grad.index_add_(0, flat, g.reshape(-1, d)[live])
        count.index_add_(0, flat, torch.ones((flat.shape[0], 1), device=dev))
    return grad, count


def lazy_adam(w, m, v, t, grad, count, lr: float, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8) -> None:
    """Per-row lazy Adam in place: rows with count > 0 step t, m, v, w."""
    live = count > 0
    t.add_(live.float())
    m_new = b1 * m + (1 - b1) * grad
    v_new = b2 * v + (1 - b2) * torch.square(grad)
    t_safe = torch.clamp(t, min=1.0)
    step = lr * (m_new / (1 - b1 ** t_safe)) / (torch.sqrt(v_new / (1 - b2 ** t_safe)) + eps)
    w.copy_(torch.where(live, w - step, w))
    m.copy_(torch.where(live, m_new, m))
    v.copy_(torch.where(live, v_new, v))


def lazy_adagrad(w, g2sum, grad, count, lr: float) -> None:
    """Per-row lazy AdaGrad in place: rows with count > 0 add mean(grad^2)
    to g2sum and step w by lr * grad / sqrt(g2sum)."""
    live = count > 0
    g2sum.copy_(torch.where(live, g2sum + torch.square(grad).mean(dim=-1, keepdim=True), g2sum))
    w.copy_(torch.where(live, w - lr * grad / torch.sqrt(g2sum), w))


class Adam:
    """Dense Adam as optax computes it: moments, then the bias-corrected
    step with the corrections taken in float32."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        for k, p in params.items():
            g = grads[k]
            mu = self.mu.setdefault(k, torch.zeros_like(p))
            nu = self.nu.setdefault(k, torch.zeros_like(p))
            mu.mul_(self.b1).add_(g * (1 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1 - self.b2))
            p.add_((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) * -self.lr)


def dense(x: torch.Tensor, params: Dict[str, torch.Tensor], name: str,
          activation=None) -> torch.Tensor:
    y = x @ params[f"{name}.kernel"] + params[f"{name}.bias"]
    if activation == "relu":
        return torch.relu(y)
    if activation == "sigmoid":
        return torch.sigmoid(y)
    if activation == "softmax":
        return torch.softmax(y, dim=-1)
    return y


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """min(max(x, lo), hi), whose gradient splits at a tie."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def cross_entropy(y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Elementwise -y log(p + 1e-6) - (1 - y) log(1 + 1e-6 - p)."""
    return -y * torch.log(p + 1e-6) - (1.0 - y) * torch.log((1.0 + 1e-6) - p)


def weighted_mean(raw: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Sample-weighted mean of a per-sample or per-element loss."""
    w = weight.reshape(raw.shape[0], *([1] * (raw.ndim - 1))).expand(raw.shape)
    return (raw * w).sum() / torch.clamp(w.sum(), min=1e-12)
