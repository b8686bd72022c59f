"""AutoInt interacting layer (multi-head self-attention over fields).

Counterpart of ``recommendsystem_tpu/nn/interacting.py``, in the transposed
``(d, F, B)`` form of its ``_xla_iteration_t``: batch is the minor dim end
to end, so the attention core is the batch-minor field-attention kernel
(K5, ``kernels/field_attention.py``) with no transpose per iteration.

- ONE set of relu Q/K/V/res projections shared across the ``layer_num``
  iterations;
- heads split head-major from the unit dim, scores scaled by sqrt(d_head),
  softmax over keys (K5);
- residual, relu and LayerNorm over the unit dim with eps 1e-3 (the Keras
  default).

Parameters keep the flax names and layout: ``wq``/``wk``/``wv``/``wr`` are
``(d, U)`` and the projections compute ``W.T @ x``; ``ln_scale``/``ln_bias``
are the LayerNorm's gamma/beta.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels.field_attention import field_attention
from .mlp import glorot_uniform_


class InteractingLayer(nn.Module):
    def __init__(self, in_dim: int, layer_num: int = 1, unit_num: int = 128,
                 head_num: int = 1, use_dropout: bool = False,
                 dropout_rate: float = 0.3, use_res: bool = True,
                 ln_epsilon: float = 1e-3, device=None):
        super().__init__()
        if unit_num % head_num != 0:
            raise ValueError("unit_num must divide head_num")
        self.in_dim = in_dim
        self.layer_num = layer_num
        self.unit_num = unit_num
        self.head_num = head_num
        self.use_dropout = use_dropout
        self.dropout_rate = dropout_rate
        self.use_res = use_res
        self.ln_epsilon = ln_epsilon

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        u = unit_num
        self.wq, self.bq = param(in_dim, u), param(u)
        self.wk, self.bk = param(in_dim, u), param(u)
        self.wv, self.bv = param(in_dim, u), param(u)
        self.ln_scale, self.ln_bias = param(u), param(u)
        if use_res:
            self.wr, self.br = param(in_dim, u), param(u)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            for w in ("wq", "wk", "wv", "wr"):
                if hasattr(self, w):
                    glorot_uniform_(getattr(self, w), generator)
            for b in ("bq", "bk", "bv", "br", "ln_bias"):
                if hasattr(self, b):
                    getattr(self, b).zero_()
            self.ln_scale.fill_(1.0)

    def _iteration_t(self, x_t: torch.Tensor, training: bool) -> torch.Tensor:
        """One iteration, (d, F, B) -> (U, F, B)."""
        d, f, b = x_t.shape
        u, h = self.unit_num, self.head_num
        flat = x_t.reshape(d, f * b)

        def proj(w, bias):                      # -> (head, d_head, F, B)
            z = torch.relu(w.t() @ flat + bias[:, None])
            return z.reshape(h, u // h, f, b)

        qt, kt, vt = (proj(self.wq, self.bq), proj(self.wk, self.bk),
                      proj(self.wv, self.bv))
        rate = self.dropout_rate if (self.use_dropout and training) else 0.0
        o = field_attention(qt, kt, vt, 0, rate).reshape(u, f, b)
        if self.use_res:
            o = o + torch.relu(self.wr.t() @ flat
                               + self.br[:, None]).reshape(u, f, b)
        o = torch.relu(o)
        mu = o.mean(dim=0, keepdim=True)
        var = (o - mu).square().mean(dim=0, keepdim=True)
        return ((o - mu) * torch.rsqrt(var + self.ln_epsilon)
                * self.ln_scale[:, None, None] + self.ln_bias[:, None, None])

    def forward(self, inputs: torch.Tensor, training: bool = False) -> torch.Tensor:
        """(B, F, D) -> (B, F, U)."""
        if inputs.ndim != 3:
            raise ValueError(
                "The rank of input of InteractingLayer must be 3, but now is %d"
                % inputs.ndim)
        # ONE entry and ONE exit transpose for the whole stack
        x_t = inputs.permute(2, 1, 0).contiguous()
        for _ in range(self.layer_num):
            x_t = self._iteration_t(x_t, training)
        return x_t.permute(2, 1, 0)
