"""Deep & Cross layers, both of the reference's parameterizations.

Counterpart of ``recommendsystem_tpu/nn/dcn.py``:

- ``DeepCrossLayer`` (staytime, the reference's ``staytime/layer.py:44-80``):
  per layer ``w_i`` (dim, 1) glorot-uniform and ``b_i`` (dim,) zeros, and
  ``cross = base * (cross @ w_i) + b_i + cross``, where ``base`` is the
  input for the first layer and the running cross after it (the
  reference's deliberate deviation from DCN-v1);
- ``CrossNet`` (rough_rank's teacher, ``rough_rank/layer.py:236-270``): per
  layer ``kernel{i}`` (dim, 1) glorot-normal and ``bias{i}`` (dim, 1)
  zeros, read as ``bias{i}[:, 0]``, and the DCN-v1 recurrence
  ``x_{l+1} = x0 * (x_l @ kernel) + bias + x_l``; ``l2_reg`` puts an L2
  penalty on every kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .mlp import dot_f32, glorot_normal_, glorot_uniform_


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
            scalar = dot_f32(cross, getattr(self, f"w_{i}"))       # (B, 1)
            base = inputs if i == 0 else cross
            cross = base * scalar + getattr(self, f"b_{i}") + cross
        return cross


class CrossNet(nn.Module):
    def __init__(self, dim: int, layer_num: int = 2, l2_reg: float = 0.0, device=None):
        super().__init__()
        self.layer_num = layer_num
        self.l2_reg = l2_reg
        for i in range(layer_num):
            setattr(self, f"kernel{i}", nn.Parameter(torch.empty((dim, 1), device=device)))
            setattr(self, f"bias{i}", nn.Parameter(torch.empty((dim, 1), device=device)))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for i in range(self.layer_num):
            glorot_normal_(getattr(self, f"kernel{i}"), generator)
            with torch.no_grad():
                getattr(self, f"bias{i}").zero_()

    def penalized_kernels(self) -> Dict[str, Tuple[float, float]]:
        if not self.l2_reg:
            return {}
        return {f"kernel{i}": (0.0, self.l2_reg) for i in range(self.layer_num)}

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x0 = xl = inputs
        for i in range(self.layer_num):
            xw = dot_f32(xl, getattr(self, f"kernel{i}"))          # (B, 1)
            xl = x0 * xw + getattr(self, f"bias{i}")[:, 0] + xl
        return xl
