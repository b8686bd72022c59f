"""Mixture-of-experts layers with their experts' parameters stacked.

Counterpart of ``recommendsystem_tpu/nn/moe_stacked.py``: the same math as
``nn/moe.py``'s MMOE and PLE and as the gated experts of ctr and staytime,
with the experts' parameters on a leading axis, as flax's ``nn.vmap``
leaves them (``experts.kernel0`` of shape (E, in, out)), so a flattened
flax tree is the layer's state dict.  The experts run as one batched
product a layer (``DNN(stack=E)``, ``Dense(stack=E)``) instead of E small
ones.  A stacked layer's L1L2 penalty is summed over its experts, as the
JAX step sums every leaf of the sown losses.  The JAX module's
``expert_shardings`` places the stack across a mesh: it belongs to the
sharded mode, which the port does not have yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from .mlp import DNN, Dense
from .moe import _gate_params, pool


class MMOEStacked(nn.Module):
    """``MMOE`` with its experts stacked: ``experts`` (a DNN of E) and
    ``task{i}_gate``."""

    def __init__(self, in_features: int, num_tasks: int, num_experts: int = 2,
                 expert_dnn_units: Sequence[int] = (32,),
                 gate_dnn_units: Sequence[int] = (),
                 expert_dnn_params: Optional[Dict[str, Any]] = None,
                 gate_dnn_params: Optional[Dict[str, Any]] = None, device=None):
        super().__init__()
        self.num_tasks = num_tasks
        gate_units = list(gate_dnn_units) + [num_experts]
        self.experts = DNN(in_features, expert_dnn_units, stack=num_experts,
                           device=device, **(expert_dnn_params or {}))
        for i in range(num_tasks):
            setattr(self, f"task{i}_gate", DNN(in_features, gate_units, device=device,
                                               **_gate_params(gate_dnn_params)))

    def forward(self, inputs: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        experts = self.experts(inputs, training, generator).transpose(0, 1)   # (B, E, D)
        return [pool(experts, getattr(self, f"task{i}_gate")(inputs, training, generator))
                for i in range(self.num_tasks)]


class PLEStacked(nn.Module):
    """``PLE`` with its experts stacked: the shared experts in one stack
    ``experts`` (S, ...), the task-specific ones in one stack
    ``specific_experts`` (T·Sp, ...), task i's the slice [i·Sp, (i+1)·Sp)."""

    def __init__(self, in_features: int, num_tasks: int, num_shared_experts: int = 2,
                 num_specific_experts: int = 2, expert_dnn_units: Sequence[int] = (32,),
                 gate_dnn_units: Sequence[int] = (),
                 expert_dnn_params: Optional[Dict[str, Any]] = None,
                 gate_dnn_params: Optional[Dict[str, Any]] = None, device=None):
        super().__init__()
        self.num_tasks, self.num_specific = num_tasks, num_specific_experts
        gate_units = list(gate_dnn_units) + [num_shared_experts + num_specific_experts]
        self.experts = DNN(in_features, expert_dnn_units, stack=num_shared_experts,
                           device=device, **(expert_dnn_params or {}))
        self.specific_experts = DNN(in_features, expert_dnn_units,
                                    stack=num_tasks * num_specific_experts,
                                    device=device, **(expert_dnn_params or {}))
        for i in range(num_tasks):
            setattr(self, f"task{i}_gate", DNN(in_features, gate_units, device=device,
                                               **_gate_params(gate_dnn_params)))

    def forward(self, inputs: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        shared = self.experts(inputs, training, generator).transpose(0, 1)     # (B, S, D)
        specific = self.specific_experts(inputs, training, generator).transpose(0, 1)
        sp = self.num_specific
        outs = []
        for i in range(self.num_tasks):
            experts = torch.cat([shared, specific[:, i * sp:(i + 1) * sp]], dim=1)
            outs.append(pool(experts, getattr(self, f"task{i}_gate")(inputs, training,
                                                                      generator)))
        return outs


class GatedExpert(nn.Module):
    """One MMoE expert of ctr and staytime with per-layer 2·sigmoid gates
    over a separate gate input (the reference's
    ``rank/ctr/model_init.py:101-118``, ``staytime/VideoDnn.py:129-151``):
    per layer j, ``g = 2 sigmoid(gate_{j}_2(relu(gate_{j}_1(gate_input))))``
    and ``expert = g * relu(expert_output_{j}(expert))``.  With ``stack=E``
    every Dense is a stack of E, and (B, in), (B, G) map to (E, B, D)."""

    def __init__(self, in_features: int, gate_features: int, hidden: Sequence[int],
                 stack: Optional[int] = None, device=None):
        super().__init__()
        self.n = len(hidden)
        for j, unit in enumerate(hidden):
            setattr(self, f"gate_{j}_1", Dense(gate_features, unit, "relu",
                                               stack=stack, device=device))
            setattr(self, f"gate_{j}_2", Dense(unit, unit, "sigmoid",
                                               stack=stack, device=device))
            setattr(self, f"expert_output_{j}", Dense(in_features, unit, "relu",
                                                      stack=stack, device=device))
            in_features = unit

    def forward(self, expert_in: torch.Tensor, gate_input: torch.Tensor) -> torch.Tensor:
        expert = expert_in
        for j in range(self.n):
            g = 2 * getattr(self, f"gate_{j}_2")(getattr(self, f"gate_{j}_1")(gate_input))
            expert = g * getattr(self, f"expert_output_{j}")(expert)
        return expert


def stacked_gated_experts(num_experts: int, hidden: Sequence[int], in_features: int,
                          gate_features: int, device=None) -> GatedExpert:
    """The stack of ``num_experts`` gated experts that the JAX
    ``stacked_gated_experts`` builds (a model keeps it as ``experts``).
    Calling it on (B, in) and (B, G) gives (E, B, D): the JAX function's
    (B, E, D) is its ``transpose(0, 1)``."""
    return GatedExpert(in_features, gate_features, tuple(hidden), stack=num_experts,
                       device=device)
