"""Factorization-machine blocks of the staytime and finish models.

Counterpart of ``FMLayer3D``, ``fm_cross_term``, ``DeepFMLayer`` and
``FFMBlock`` in ``recommendsystem_tpu/nn/fm.py``:

- ``FMLayer3D``: the pairwise interaction sum of (B, F, D) field
  embeddings, without a linear term: (B, 1); no parameters;
- ``fm_cross_term``: the listwise FM over a list of equal-width (B, D)
  field embeddings; returns the (B, D) cross term and the (B, 1) logit;
- ``DeepFMLayer``: finish's FM over a flat (B, in) concat: the order-2
  term through an ``(in, factor_dim)`` factor matrix ``weight``
  (glorot-normal) plus the linear ``Dense(1)`` named ``deeepfmlinear`` (the
  reference's spelling, so the flax tree carries across); (B, 1);
- ``FFMBlock``: per (x, y) field pair, both projected to ``dim`` by their
  own Dense layers (``ffm_x_{x}_{y}_{dim}``, ``ffm_y_{x}_{y}_{dim}``) and
  multiplied.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from .mlp import Dense, dot_f32, glorot_normal_


class FMLayer3D(nn.Module):
    """0.5 * sum_d ((sum_f x)^2 - sum_f x^2) over a (B, F, D) input."""

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        if inputs.ndim != 3:
            raise ValueError(f"Unexpected inputs dimensions {inputs.ndim}, expect to be "
                             f"3 dimensions")
        square_of_sum = torch.square(inputs.sum(dim=1, keepdim=True))
        sum_of_square = (inputs * inputs).sum(dim=1, keepdim=True)
        return 0.5 * (square_of_sum - sum_of_square).sum(dim=-1)     # (B, 1)


def fm_cross_term(field_embs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    stacked = torch.stack(list(field_embs), dim=0)             # (F, B, D)
    sum_embs = stacked.sum(dim=0)
    cross = sum_embs * sum_embs - (stacked * stacked).sum(dim=0)
    return cross, 0.5 * cross.sum(dim=-1, keepdim=True)


class DeepFMLayer(nn.Module):
    """0.5 * sum_f ((x W)_f^2 - (x^2 W^2)_f) + x @ k + b over a (B, in)
    input, as the JAX layer computes it."""

    def __init__(self, in_features: int, factor_dim: int = 8, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((in_features, factor_dim), device=device))
        self.deeepfmlinear = Dense(in_features, 1, device=device)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        glorot_normal_(self.weight, generator)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        sum_square = torch.square(dot_f32(inputs, self.weight))
        square_sum = dot_f32(torch.square(inputs), torch.square(self.weight))
        high_order = 0.5 * (sum_square - square_sum).sum(dim=1, keepdim=True)
        return high_order + self.deeepfmlinear(inputs)


class FFMBlock(nn.Module):
    """``ffm_slots``: (x_slots, y_slots, dim) triples; ``slot_dims``: the
    input width of every slot named there.  The input is a dict slot ->
    (B, D); the output the concatenated (B, pairs * dim) products."""

    def __init__(self, ffm_slots: Sequence[Tuple[Sequence[str], Sequence[str], int]],
                 slot_dims: Mapping[str, int], device=None):
        super().__init__()
        self.pairs: List[Tuple[str, str, int]] = []
        for x_list, y_list, dim in ffm_slots:
            for x in x_list:
                for y in y_list:
                    setattr(self, f"ffm_x_{x}_{y}_{dim}",
                            Dense(slot_dims[x], dim, device=device))
                    setattr(self, f"ffm_y_{x}_{y}_{dim}",
                            Dense(slot_dims[y], dim, device=device))
                    self.pairs.append((x, y, dim))

    def forward(self, slot_dict: Dict[str, torch.Tensor]) -> torch.Tensor:
        ffm = [getattr(self, f"ffm_x_{x}_{y}_{dim}")(slot_dict[x])
               * getattr(self, f"ffm_y_{x}_{y}_{dim}")(slot_dict[y])
               for x, y, dim in self.pairs]
        return torch.cat(ffm, dim=-1)
