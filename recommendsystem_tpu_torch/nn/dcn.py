"""Deep & Cross layers: both of the reference's parameterizations, and
DCN-V2's low-rank cross.

Counterpart of ``recommendsystem_tpu/nn/dcn.py`` (the first two):

- ``DeepCrossLayer`` (staytime, the reference's ``staytime/layer.py:44-80``):
  per layer ``w_i`` (dim, 1) glorot-uniform and ``b_i`` (dim,) zeros, and
  ``cross = base * (cross @ w_i) + b_i + cross``, where ``base`` is the
  input for the first layer and the running cross after it (the
  reference's deliberate deviation from DCN-v1);
- ``CrossNet`` (rough_rank's teacher, ``rough_rank/layer.py:236-270``): per
  layer ``kernel{i}`` (dim, 1) glorot-normal and ``bias{i}`` (dim, 1)
  zeros, read as ``bias{i}[:, 0]``, and the DCN-v1 recurrence
  ``x_{l+1} = x0 * (x_l @ kernel) + bias + x_l``; ``l2_reg`` puts an L2
  penalty on every kernel;
- ``LowRankCrossNet`` (DLRM-DCNv2; DCN-V2, Wang et al., arXiv:2008.13535,
  with its low-rank cross): per layer ``v_{i}`` (in, rank) and ``w_{i}``
  (rank, in), glorot-uniform, and ``b_{i}`` (in,) zeros, and
  ``x_{l+1} = x0 * ((x_l @ v_i) @ w_i + b_i) + x_l``.  It runs as one
  autograd function over its layers: the forward's products are cuBLAS
  GEMMs (``addmm``) and its elementwise step one ``addcmul``; the backward
  walks the layers back and takes each layer's elementwise part (du,
  x0's share, db) in one pass of K10 (``kernels/dcn_cross.py``), which
  accumulates x0's gradient over the layers in one buffer.  It computes in
  float32: under the bf16 compute policy its input and params are
  widened at entry, and their gradients rounded back by the casts.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels.dcn_cross import dcn_cross_bwd
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


def _cross_forward(x0: torch.Tensor, params) -> Tuple[torch.Tensor, list]:
    """x_L and, for each layer, (x_l, x_l @ v, u) of the low-rank cross over
    ``params`` (v, w, b of each layer in turn)."""
    x, saved = x0, []
    for i in range(0, len(params), 3):
        v, w, b = params[i:i + 3]
        t = torch.mm(x, v)
        u = torch.addmm(b, t, w)
        saved.append((x, t, u))
        x = torch.addcmul(x, x0, u)
    return x, saved


class _LowRankCross(torch.autograd.Function):
    """The low-rank cross net over its float32 input and params; the
    backward runs K10 at each layer (module docstring)."""

    @staticmethod
    def forward(ctx, x0, *params):
        out, saved = _cross_forward(x0, params)
        ctx.save_for_backward(x0, *params, *(t for layer in saved for t in layer))
        ctx.layers = len(params) // 3
        return out

    @staticmethod
    def backward(ctx, g):
        n = ctx.layers
        x0, *rest = ctx.saved_tensors
        params, saved = rest[:3 * n], rest[3 * n:]
        grads = [None] * (3 * n)
        g = g.contiguous()
        dx0 = torch.empty_like(x0)
        for i in reversed(range(n)):
            v, w, _ = params[3 * i:3 * i + 3]
            x, t, u = saved[3 * i:3 * i + 3]
            # du = g * x0; dx0 (+)= g * u, and + g at the first layer, whose x_l is x0
            du, partial = dcn_cross_bwd(g, x0, u, dx0, accumulate=i < n - 1,
                                        residual=i == 0)
            dt = torch.mm(du, w.t())
            grads[3 * i:3 * i + 3] = (torch.mm(x.t(), dt), torch.mm(t.t(), du),
                                      partial.sum(dim=0))
            if i == 0:
                dx0.addmm_(dt, v.t())
            else:
                g = torch.addmm(g, dt, v.t())
        return (dx0, *grads)


class LowRankCrossNet(nn.Module):
    """DCN-V2's cross net with low-rank layers (module docstring):
    ``num_layers`` layers over rows of ``in_features``, each through a
    ``rank``-wide bottleneck."""

    def __init__(self, in_features: int, rank: int, num_layers: int = 3, device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"v_{i}", nn.Parameter(torch.empty((in_features, rank),
                                                             device=device)))
            setattr(self, f"w_{i}", nn.Parameter(torch.empty((rank, in_features),
                                                             device=device)))
            setattr(self, f"b_{i}", nn.Parameter(torch.empty((in_features,), device=device)))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for i in range(self.num_layers):
            glorot_uniform_(getattr(self, f"v_{i}"), generator)
            glorot_uniform_(getattr(self, f"w_{i}"), generator)
            with torch.no_grad():
                getattr(self, f"b_{i}").zero_()

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        params = [getattr(self, f"{p}_{i}").float() for i in range(self.num_layers)
                  for p in ("v", "w", "b")]
        x0 = inputs.float()
        if torch.is_grad_enabled() and (x0.requires_grad
                                        or any(p.requires_grad for p in params)):
            return _LowRankCross.apply(x0.contiguous(), *params)
        return _cross_forward(x0, params)[0]
