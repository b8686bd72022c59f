"""SENet field reweighting, both squeeze variants.

Counterpart of ``recommendsystem_tpu/nn/senet.py``:

- ``squeeze="mean"``: each field embedding squeezed to its scalar mean,
  concatenated to (B, F) (the ctr variant);
- ``squeeze="concat"``: the full field embeddings concatenated to (B, F*D)
  (the staytime variant).

Common trunk: the squeezed input is detached (``stop_gradient``), then
Dense(F // reduction, relu) ``senet_squeeze_layer``, ``2 * Dense(F,
sigmoid)`` ``senet_extract_layer``, and each field is scaled by its gate.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from .mlp import Dense


class SENet(nn.Module):
    def __init__(self, num_fields: int, field_dim: int, squeeze: str = "mean",
                 reduction: int = 4, device=None):
        super().__init__()
        if squeeze not in ("mean", "concat"):
            raise ValueError(squeeze)
        self.squeeze = squeeze
        in_features = num_fields * field_dim if squeeze == "concat" else num_fields
        self.senet_squeeze_layer = Dense(in_features, num_fields // reduction,
                                         "relu", device=device)
        self.senet_extract_layer = Dense(num_fields // reduction, num_fields,
                                         "sigmoid", device=device)

    def forward(self, field_embs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if self.squeeze == "mean":
            squeezed = torch.cat([e.mean(dim=1, keepdim=True) for e in field_embs],
                                 dim=1)
        else:
            squeezed = torch.cat(list(field_embs), dim=-1)
        h = self.senet_squeeze_layer(squeezed.detach())
        gates = 2.0 * self.senet_extract_layer(h)                 # (B, F)
        return [emb * gates[:, i:i + 1] for i, emb in enumerate(field_embs)]
