"""PPNet gate bank of the ctr model.

Counterpart of ``PPNetGateBank`` in ``recommendsystem_tpu/nn/ppnet.py``:
ONE Dense ``dnn_ppnet_gate`` over the gate input produces every gate,
``scale * sigmoid``, split by ``splits`` (the reference's
``rank/ctr/model_init.py:66-68``).  ``GateTower`` comes with the models
that use it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from .mlp import Dense


class PPNetGateBank(nn.Module):
    def __init__(self, in_features: int, splits: Sequence[int], scale: float = 2.0,
                 device=None):
        super().__init__()
        self.splits = tuple(splits)
        self.scale = scale
        self.dnn_ppnet_gate = Dense(in_features, sum(self.splits), "sigmoid",
                                    device=device)

    def forward(self, gate_input: torch.Tensor) -> List[torch.Tensor]:
        gates = self.scale * self.dnn_ppnet_gate(gate_input)
        return list(torch.split(gates, self.splits, dim=1))
