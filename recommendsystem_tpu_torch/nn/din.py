"""DIN target attention: the staytime pool and the general variant.

Counterpart of ``DINAttention``, ``DINPool``, ``MASK_PAD`` and
``sequence_mask`` in ``recommendsystem_tpu/nn/din.py``.  ``DINPool`` is the
single-query softmax DIN of the reference's ``staytime/layer.py:6-41``.  A scorer MLP [16 sigmoid, 1 linear]
over [q, f, q - f, q * f] scores each fact; masked positions get
``MASK_PAD`` (-2**32 + 1, which replaces the score), then a softmax over the
sequence weights the sum of the facts.  The pool is K7 (``kernels/din.py``):
the CUDA kernel on a card, its plain version on the CPU.  The kernel takes
the staytime widths (H = 16, a scorer of width 16); on a card other widths
raise.  The facts may be a ``SequenceRows`` handle (the predict step's
sequence columns): K7 then gathers them from the table itself.

``DINAttention`` is the general F-query variant of the reference's
``din.py:6-47``, kept numerically distinct as in the JAX package: a scorer
of Dense layers (``din_nn_{i}``, ReLU each) over [q, k, q * k], masked
scores set to 0 (not ``MASK_PAD``) and no softmax, then a plain product
with the values.  It has no kernel: no model of the zoo uses it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..embedding.packed import SequenceRows
from ..kernels.din import HIDDEN, MASK_PAD, din_pool, din_pool_gather  # noqa: F401
from .mlp import Dense, einsum_f32, glorot_uniform_


def sequence_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """``tf.sequence_mask``: (B,) int -> (B, maxlen) bool."""
    pos = torch.arange(maxlen, device=lengths.device)[None, :]
    return pos < lengths[:, None]


class DINPool(nn.Module):
    """query (B, H); facts (B, T, H) and mask (B, T) bool or None, or facts
    a ``SequenceRows`` handle whose window is H wide (it carries its mask
    and its facts' type; no gradient).  Returns (B, H) float32; the query,
    the facts and the parameters all float32 or, under the bf16 compute
    policy, all bf16.  Parameters keep the flax names and
    layout: ``w1`` (4H, hidden), ``b1`` (hidden,), ``w2`` (hidden, 1),
    ``b2`` (1,)."""

    def __init__(self, in_dim: int, hidden: int = HIDDEN, device=None):
        super().__init__()
        self.w1 = nn.Parameter(torch.empty((4 * in_dim, hidden), device=device))
        self.b1 = nn.Parameter(torch.empty((hidden,), device=device))
        self.w2 = nn.Parameter(torch.empty((hidden, 1), device=device))
        self.b2 = nn.Parameter(torch.empty((1,), device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Glorot-uniform scorer kernels and zero biases, as flax."""
        glorot_uniform_(self.w1, generator)
        glorot_uniform_(self.w2, generator)
        with torch.no_grad():
            self.b1.zero_()
            self.b2.zero_()

    def forward(self, query: torch.Tensor, facts,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if isinstance(facts, SequenceRows):
            if mask is not None:
                raise ValueError("DINPool: a SequenceRows handle carries its own mask")
            return din_pool_gather(query, facts.table, facts.ids, facts.mask,
                                   facts.window, self.w1, self.b1, self.w2, self.b2,
                                   facts.dtype)
        if mask is None:
            mask_f = torch.ones(facts.shape[:2], dtype=torch.float32,
                                device=facts.device)
        else:
            mask_f = mask.to(torch.float32)
        return din_pool(query, facts, mask_f, self.w1, self.b1, self.w2, self.b2)


class DINAttention(nn.Module):
    """queries (B, H) or (B, F, H); keys and values (B, T, H); mask (B, T)
    bool or None.  Returns (B, H) for 2-d queries, else (B, F, H).  The
    scorer maps the 3H features through ``hidden_units`` (the last must be
    1), each a ReLU ``Dense`` named ``din_nn_{i}`` as in flax."""

    def __init__(self, in_dim: int, hidden_units: Sequence[int] = (16, 1), device=None):
        super().__init__()
        if not hidden_units or hidden_units[-1] != 1:
            raise ValueError(f"DINAttention: the scorer must end in one unit, got "
                             f"{tuple(hidden_units)}")
        self.hidden_units = tuple(hidden_units)
        width = 3 * in_dim
        for i, unit in enumerate(self.hidden_units):
            setattr(self, f"din_nn_{i}", Dense(width, unit, "relu", device=device))
            width = unit

    def forward(self, queries: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        squeeze_f = queries.ndim == 2
        if squeeze_f:
            queries = queries[:, None, :]                          # (B, 1, H)
        b, f, h = queries.shape
        t = keys.shape[1]
        q = queries[:, :, None, :].expand(b, f, t, h)
        k = keys[:, None, :, :].expand(b, f, t, keys.shape[-1])
        deep = torch.cat([q, k, q * k], dim=-1)                    # (B, F, T, 3H)
        for i in range(len(self.hidden_units)):
            deep = getattr(self, f"din_nn_{i}")(deep)
        deep = deep.squeeze(-1)                                    # (B, F, T)
        if mask is not None:
            deep = torch.where(mask[:, None, :].expand(deep.shape), deep,
                               torch.zeros_like(deep))             # zeroed, not MASK_PAD
        out = einsum_f32("bft,bth->bfh", deep, values)
        return out.squeeze(1) if squeeze_f else out
