"""Deep & Cross layer of the staytime model.

Counterpart of ``DeepCrossLayer`` in ``recommendsystem_tpu/nn/dcn.py``
(the reference's ``staytime/layer.py:44-80``): per layer ``w_i`` (dim, 1)
glorot-uniform and ``b_i`` (dim,) zeros, and
``cross = base * (cross @ w_i) + b_i + cross``, where ``base`` is the
input for the first layer and the running cross after it (the reference's
deliberate deviation from DCN-v1).  ``CrossNet`` comes with rough_rank.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .mlp import glorot_uniform_


class DeepCrossLayer(nn.Module):
    def __init__(self, dim: int, num_layer: int = 3, device=None):
        super().__init__()
        self.num_layer = num_layer
        for i in range(num_layer):
            setattr(self, f"w_{i}", nn.Parameter(torch.empty((dim, 1), device=device)))
            setattr(self, f"b_{i}", nn.Parameter(torch.empty((dim,), device=device)))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for i in range(self.num_layer):
            glorot_uniform_(getattr(self, f"w_{i}"), generator)
            with torch.no_grad():
                getattr(self, f"b_{i}").zero_()

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        cross = inputs
        for i in range(self.num_layer):
            scalar = cross @ getattr(self, f"w_{i}")                # (B, 1)
            base = inputs if i == 0 else cross
            cross = base * scalar + getattr(self, f"b_{i}") + cross
        return cross
