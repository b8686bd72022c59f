"""Factorization-machine blocks of the staytime model.

Counterpart of ``fm_cross_term`` and ``FFMBlock`` in
``recommendsystem_tpu/nn/fm.py``:

- ``fm_cross_term``: the listwise FM over a list of equal-width (B, D)
  field embeddings; returns the (B, D) cross term and the (B, 1) logit;
- ``FFMBlock``: per (x, y) field pair, both projected to ``dim`` by their
  own Dense layers (``ffm_x_{x}_{y}_{dim}``, ``ffm_y_{x}_{y}_{dim}``) and
  multiplied.

``FMLayer3D`` and ``DeepFMLayer`` come with the models that use them.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch
from torch import nn

from .mlp import Dense


def fm_cross_term(field_embs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    stacked = torch.stack(list(field_embs), dim=0)             # (F, B, D)
    sum_embs = stacked.sum(dim=0)
    cross = sum_embs * sum_embs - (stacked * stacked).sum(dim=0)
    return cross, 0.5 * cross.sum(dim=-1, keepdim=True)


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
