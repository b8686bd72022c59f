"""AutoInt interacting layer (multi-head self-attention over fields).

Counterpart of ``recommendsystem_tpu/nn/interacting.py`` in two forms: the
fused iteration (K6) where it applies, else the transposed ``(d, F, B)``
form of its ``_xla_iteration_t``, in which batch is the minor dim end to
end, so the attention core is the batch-minor field-attention kernel (K5,
``kernels/field_attention.py``) with no transpose per iteration.

- ONE set of relu Q/K/V/res projections shared across the ``layer_num``
  iterations;
- heads split head-major from the unit dim, scores scaled by sqrt(d_head),
  softmax over keys (K5), and in training with ``use_dropout`` dropout on
  the attention weights, drawn in the kernel from one seed per iteration:
  ``(seed << 32) | i`` for iteration i of a step with seed ``seed``, so the
  kernel's Philox key is (step seed, iteration), as the JAX layer derives
  ``base + i`` (``nn/interacting.py:147-159``);
- residual, relu and LayerNorm over the unit dim with eps 1e-3 (the Keras
  default).

Parameters keep the flax names and layout: ``wq``/``wk``/``wv``/``wr`` are
``(d, U)`` and the projections compute ``W.T @ x``; ``ln_scale``/``ln_bias``
are the LayerNorm's gamma/beta.

The layer picks its kernel from what it sees, as the JAX layer under
``set_backend("pallas")`` does (``nn/interacting.py:142-144,167-174``):
with ``use_res`` set, unless the call trains with ``use_dropout``, and at
the widths the fused kernel takes (``kernels.interacting.kernel_takes``:
D = U = 8, F <= 256, the widths of every model that builds the layer),
each iteration runs the fused kernel (K6, ``kernels/interacting.py``) in
the ``(B, F, D)`` layout; any other call runs ``forward_transposed``.  The
JAX package also asks for a batch that is a multiple of 128 before it
prefers its flash attention; that rule follows the TPU's lane tile and is
not carried over.

Under the bf16 compute policy the layer keeps the JAX package's dtypes
with its kernels (``set_backend("pallas")``): K6 takes bf16 x and
parameters and returns float32; on the transposed path the projections
are JAX's ``W.T @ x`` with no ``preferred_element_type`` (bf16 from bf16
x and weights: ``matmul_promoted``), K5 takes the bf16 q, k and v and
returns float32 o, and the residual, ReLU and LayerNorm then run in
float32, as every later iteration does (its float32 x promotes the bf16
weights).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels.field_attention import field_attention
from ..kernels.interacting import interacting_attention, kernel_takes
from .mlp import glorot_uniform_, matmul_promoted


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

    def _iteration_t(self, x_t: torch.Tensor, training: bool,
                     seed: int) -> torch.Tensor:
        """One iteration, (d, F, B) -> (U, F, B)."""
        d, f, b = x_t.shape
        u, h = self.unit_num, self.head_num
        flat = x_t.reshape(d, f * b)

        def proj(w, bias):                      # -> (head, d_head, F, B)
            z = torch.relu(matmul_promoted(w.t(), flat) + bias[:, None])
            return z.reshape(h, u // h, f, b)

        qt, kt, vt = (proj(self.wq, self.bq), proj(self.wk, self.bk),
                      proj(self.wv, self.bv))
        rate = self.dropout_rate if (self.use_dropout and training) else 0.0
        o = field_attention(qt, kt, vt, seed, rate).reshape(u, f, b)
        if self.use_res:
            o = o + torch.relu(matmul_promoted(self.wr.t(), flat)
                               + self.br[:, None]).reshape(u, f, b)
        o = torch.relu(o)
        mu = o.mean(dim=0, keepdim=True)
        var = (o - mu).square().mean(dim=0, keepdim=True)
        return ((o - mu) * torch.rsqrt(var + self.ln_epsilon)
                * self.ln_scale[:, None, None] + self.ln_bias[:, None, None])

    @staticmethod
    def _check(inputs: torch.Tensor, seed: int) -> None:
        if not 0 <= seed < 1 << 32:
            raise ValueError(f"seed {seed} not in [0, 2**32)")
        if inputs.ndim != 3:
            raise ValueError(
                "The rank of input of InteractingLayer must be 3, but now is %d"
                % inputs.ndim)

    def forward(self, inputs: torch.Tensor, training: bool = False,
                seed: int = 0) -> torch.Tensor:
        """(B, F, D) -> (B, F, U); ``seed`` (below 2**32) draws the
        attention dropout of a training step."""
        self._check(inputs, seed)
        if not (self.use_res and not (self.use_dropout and training)
                and kernel_takes(self.in_dim, self.unit_num, inputs.shape[1])):
            return self.forward_transposed(inputs, training, seed)
        p = {"wq": self.wq, "bq": self.bq, "wk": self.wk, "bk": self.bk,
             "wv": self.wv, "bv": self.bv, "wr": self.wr, "br": self.br,
             "gamma": self.ln_scale, "beta": self.ln_bias}
        output = inputs.contiguous()
        for _ in range(self.layer_num):
            output = interacting_attention(output, p, self.head_num, self.ln_epsilon)
        return output

    def forward_transposed(self, inputs: torch.Tensor, training: bool = False,
                           seed: int = 0) -> torch.Tensor:
        """The layer in the transposed layout through K5, whatever the
        widths: (B, F, D) -> (B, F, U) behind ONE entry and ONE exit
        transpose for the whole stack."""
        self._check(inputs, seed)
        x_t = inputs.permute(2, 1, 0).contiguous()
        for i in range(self.layer_num):
            x_t = self._iteration_t(x_t, training, (seed << 32) | i)
        return x_t.permute(2, 1, 0)
