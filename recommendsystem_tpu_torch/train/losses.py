"""Loss functions of the port.

Counterpart of ``recommendsystem_tpu/train/losses.py``; the other losses
come with the models that use them.
"""

from __future__ import annotations

import torch


def cross_entropy_sum_mean(y_true: torch.Tensor, y_pred: torch.Tensor,
                           a: float = 1.0) -> torch.Tensor:
    """ctr/finish cross-entropy: -y log(p + 1e-6) - (a - y) log(1 - p + 1e-6),
    summed over the label axis, then the batch mean.  A scalar, so the
    sample weights of a step never reach it (as in the JAX package).

    ``1 - p + 1e-6`` is taken as ``(1 + 1e-6) - p``, the form XLA folds the
    JAX package's jitted loss into: where the clipped sigmoid saturates to
    exactly 1.0, the two forms give 9.54e-7 and 1e-6, a loss 0.3% apart."""
    y_true = y_true.float()
    loss = (-y_true * torch.log(y_pred + 1e-6)
            - (a - y_true) * torch.log((1.0 + 1e-6) - y_pred))
    return loss.sum(dim=1).mean(dim=0)
