"""PPNet-style personalized gates.

Counterpart of ``recommendsystem_tpu/nn/ppnet.py``:

- ``GateTower``: an optional hidden relu Dense ``gate_hidden``, then
  ``scale * sigmoid`` of Dense ``gate_out``;
- ``PPNetGateBank`` (ctr): ONE Dense ``dnn_ppnet_gate`` over the gate input
  produces every gate, ``scale * sigmoid``, split by ``splits`` (the
  reference's ``rank/ctr/model_init.py:66-68``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from .mlp import Dense


class GateTower(nn.Module):
    def __init__(self, in_features: int, out_units: int,
                 hidden_units: Optional[int] = None, scale: float = 2.0,
                 kernel_regularizer: Optional[Tuple[float, float]] = None,
                 device=None):
        super().__init__()
        self.scale = scale
        self.gate_hidden = None
        if hidden_units is not None:
            self.gate_hidden = Dense(in_features, hidden_units, "relu",
                                     kernel_regularizer=kernel_regularizer, device=device)
            in_features = hidden_units
        self.gate_out = Dense(in_features, out_units, "sigmoid",
                              kernel_regularizer=kernel_regularizer, device=device)

    def forward(self, gate_input: torch.Tensor) -> torch.Tensor:
        x = gate_input if self.gate_hidden is None else self.gate_hidden(gate_input)
        return self.scale * self.gate_out(x)


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
