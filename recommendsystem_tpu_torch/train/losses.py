"""Loss functions of the port.

Counterpart of ``recommendsystem_tpu/train/losses.py``; the other losses
come with the models that use them.

``1 - p + 1e-6`` is taken as ``(1 + 1e-6) - p``, the form XLA folds the
JAX package's jitted losses into: where a sigmoid saturates to exactly 1.0,
the two forms give 9.54e-7 and 1e-6, a loss 0.3% apart.  Clips are
min/max, as ``jnp.clip`` computes them.
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
    lo, hi = y_p.new_tensor(K_EPSILON), y_p.new_tensor(1.0)
    y_t = torch.minimum(torch.maximum(y_t, lo), hi)
    y_p = torch.minimum(torch.maximum(y_p, lo), hi)
    return (y_t * torch.log(y_t / y_p)).sum(dim=-1)
