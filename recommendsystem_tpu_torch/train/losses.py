"""Loss functions of the port.

Counterpart of ``recommendsystem_tpu/train/losses.py``: every loss the
reference defines, and the ``LOSSES`` registry under the JAX names.

``1 - p + 1e-6`` is taken as ``(1 + 1e-6) - p``, the form XLA folds the
JAX package's jitted losses into: where a sigmoid saturates to exactly 1.0,
the two forms give 9.54e-7 and 1e-6, a loss 0.3% apart.  Clips are
min/max, as ``jnp.clip`` computes them, against bounds made on the
tensor's device by a fill (``_bound``): a bound copied from the host could
not be captured in a CUDA graph.
"""

from __future__ import annotations

import torch

K_EPSILON = 1e-7   # tf.keras.backend.epsilon()


def cross_entropy_sum_mean(y_true: torch.Tensor, y_pred: torch.Tensor,
                           a: float = 1.0) -> torch.Tensor:
    """ctr/finish cross-entropy: -y log(p + 1e-6) - (a - y) log(1 - p + 1e-6),
    summed over the label axis, then the batch mean.  A scalar, so the
    sample weights of a step never reach it (as in the JAX package)."""
    return cross_entropy_elementwise(y_true, y_pred, a).sum(dim=1).mean(dim=0)


def cross_entropy_per_sample(y_true: torch.Tensor, y_pred: torch.Tensor,
                             a: float = 1.0) -> torch.Tensor:
    """multi_head cross-entropy: summed over the label axis per sample,
    (B, 1), no batch reduction."""
    return cross_entropy_elementwise(y_true, y_pred, a).sum(dim=-1, keepdim=True)


def cross_entropy_elementwise(y_true: torch.Tensor, y_pred: torch.Tensor,
                              a: float = 1.0) -> torch.Tensor:
    """staytime cross-entropy, elementwise with no reduction."""
    y_true = y_true.float()
    return (-y_true * torch.log(y_pred + 1e-6)
            - (a - y_true) * torch.log((1.0 + 1e-6) - y_pred))


def kl_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
            multiclass_num: int = 400) -> torch.Tensor:
    """staytime KL over the first ``multiclass_num`` columns, per sample
    (B,); the last column of ``y_true`` carries the raw label."""
    y_t = y_true[:, :multiclass_num].to(y_pred.dtype)
    y_p = y_pred[:, :multiclass_num]
    y_t = _clip(y_t, K_EPSILON, 1.0)
    y_p = _clip(y_p, K_EPSILON, 1.0)
    return (y_t * torch.log(y_t / y_p)).sum(dim=-1)


def _bound(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``x``'s dtype on its device, filled
    there (``x.new_tensor(value)``'s result without its host copy)."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: max with ``lo``, then min with ``hi``, each bound in
    the tensor's dtype."""
    return torch.minimum(torch.maximum(x, _bound(x, lo)), _bound(x, hi))


def mse_clip_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
                  clip: float = 2.0) -> torch.Tensor:
    """staytime's mean squared error with the label cut at ``clip``."""
    y_true = torch.minimum(y_true.float(), _bound(y_pred, clip))
    return (y_true - y_pred).square().mean()


def huber_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
               clip_delta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber loss: 0.5 e^2 below ``clip_delta``, linear above."""
    error = y_true - y_pred
    cond = error.abs() < clip_delta
    squared = 0.5 * error.square()
    linear = clip_delta * (error.abs() - 0.5 * clip_delta)
    return torch.where(cond, squared, linear)


def log_mse_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
                 upper: float = 5.3) -> torch.Tensor:
    """rough_rank's watch-time loss: the mean squared error against
    log(1 + ms / 1000), cut at ``upper``."""
    wt_log = torch.log(y_true.float() / 1000.0 + 1.0)
    return (torch.minimum(wt_log, _bound(y_pred, upper)) - y_pred).square().mean()


def y_pred_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """A per-sample loss computed by the model (rough_rank's distillation
    head), passed through as its mean, a 0-d tensor; the label is not
    read."""
    return y_pred.mean()


def binary_cross_entropy(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Keras ``BinaryCrossentropy`` on probabilities: clipped to
    [K_EPSILON, 1 - K_EPSILON], then the mean, a 0-d tensor."""
    y_true = y_true.float()
    p = _clip(y_pred, K_EPSILON, 1.0 - K_EPSILON)
    return (-(y_true * torch.log(p) + (1.0 - y_true) * torch.log(1.0 - p))).mean()


LOSSES = {
    "cross_entropy_sum_mean": cross_entropy_sum_mean,
    "cross_entropy_per_sample": cross_entropy_per_sample,
    "cross_entropy_elementwise": cross_entropy_elementwise,
    "kl": kl_loss,
    "mse_clip": mse_clip_loss,
    "huber": huber_loss,
    "log_mse": log_mse_loss,
    "y_pred": y_pred_loss,
    "bce": binary_cross_entropy,
}
