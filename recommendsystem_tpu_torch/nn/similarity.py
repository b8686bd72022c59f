"""Similarity and distillation loss of rough_rank.

Counterpart of ``recommendsystem_tpu/nn/similarity.py`` (the reference's
``rough_rank/layer.py:6-30, 272-279``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class Similarity(nn.Module):
    """The dot product of a user and an item embedding, (B, 1), optionally
    through a sigmoid."""

    def __init__(self, use_sigmoid: bool = False):
        super().__init__()
        self.use_sigmoid = use_sigmoid

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        user_emb, item_emb = inputs
        out = (user_emb * item_emb).sum(dim=-1, keepdim=True)
        return torch.sigmoid(out) if self.use_sigmoid else out


def kd_loss(student_predictions: torch.Tensor,
            teacher_predictions: torch.Tensor) -> torch.Tensor:
    """Per-sample mean squared distance of the student from the teacher
    over the last axis, (B,) (Keras ``Reduction.NONE``)."""
    return (teacher_predictions - student_predictions).square().mean(dim=-1)
