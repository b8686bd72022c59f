"""Mixture-of-experts layers of rough_rank: MMoE and PLE.

Counterpart of ``recommendsystem_tpu/nn/moe.py`` (the reference's
``rough_rank/layer.py:120-233``).  Experts are ``DNN(expert_dnn_units)``;
a task's gate is ``DNN(gate_dnn_units + [E], output_activation="softmax")``
over the same inputs; a task's output pools its experts' (B, E, D) outputs
by its gate, ``einsum("bed,be->bd")``.  Submodules carry the flax names
(``expert{i}``; ``shared_expert{i}``, ``task{i}_expert{j}``;
``task{i}_gate``), so a flattened flax tree is the layer's state dict.

Every expert and gate of a PLE reads the same inputs, so the layer takes
their first layers as ONE product of the inputs with those kernels
concatenated (12 experts and 2 gates in rough_rank's user tower: one GEMM
in place of 14), then applies each module's activation, dropout and deeper
layers in module order (shared experts, then each task's experts and
gate), so that dropout draws from the generator in that order.  The
parameters stay per module.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from .mlp import DNN, dot_f32, einsum_f32


def _gate_params(gate_dnn_params: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    params = {"output_activation": "softmax"}
    params.update(gate_dnn_params or {})
    return params


def pool(experts: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """(B, E, D) expert outputs pooled by a (B, E) gate: (B, D)."""
    return einsum_f32("bed,be->bd", experts, gate)


class MMOE(nn.Module):
    def __init__(self, in_features: int, num_tasks: int, num_experts: int = 2,
                 expert_dnn_units: Sequence[int] = (32,),
                 gate_dnn_units: Sequence[int] = (),
                 expert_dnn_params: Optional[Dict[str, Any]] = None,
                 gate_dnn_params: Optional[Dict[str, Any]] = None, device=None):
        super().__init__()
        self.num_tasks, self.num_experts = num_tasks, num_experts
        gate_units = list(gate_dnn_units) + [num_experts]
        for i in range(num_experts):
            setattr(self, f"expert{i}", DNN(in_features, expert_dnn_units, device=device,
                                            **(expert_dnn_params or {})))
        for i in range(num_tasks):
            setattr(self, f"task{i}_gate", DNN(in_features, gate_units, device=device,
                                               **_gate_params(gate_dnn_params)))

    def forward(self, inputs: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        experts = torch.stack([getattr(self, f"expert{i}")(inputs, training, generator)
                               for i in range(self.num_experts)], dim=-2)   # (B, E, D)
        return [pool(experts, getattr(self, f"task{i}_gate")(inputs, training, generator))
                for i in range(self.num_tasks)]


class PLE(nn.Module):
    def __init__(self, in_features: int, num_tasks: int, num_shared_experts: int = 2,
                 num_specific_experts: int = 2, expert_dnn_units: Sequence[int] = (32,),
                 gate_dnn_units: Sequence[int] = (),
                 expert_dnn_params: Optional[Dict[str, Any]] = None,
                 gate_dnn_params: Optional[Dict[str, Any]] = None, device=None):
        super().__init__()
        self.num_tasks = num_tasks
        self.num_shared, self.num_specific = num_shared_experts, num_specific_experts
        gate_units = list(gate_dnn_units) + [num_shared_experts + num_specific_experts]

        def expert():
            return DNN(in_features, expert_dnn_units, device=device,
                       **(expert_dnn_params or {}))

        for i in range(num_shared_experts):
            setattr(self, f"shared_expert{i}", expert())
        for i in range(num_tasks):
            for j in range(num_specific_experts):
                setattr(self, f"task{i}_expert{j}", expert())
            setattr(self, f"task{i}_gate", DNN(in_features, gate_units, device=device,
                                               **_gate_params(gate_dnn_params)))

    def model_axis_reads(self) -> Dict[str, None]:
        """The first layers' kernels go whole into one product (None: no
        layer here reads them as column shards)."""
        return {f"{name}.kernel0": None for name, mod in self.named_children()
                if isinstance(mod, DNN)}

    def forward(self, inputs: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        shared = [getattr(self, f"shared_expert{i}") for i in range(self.num_shared)]
        tasks = [[getattr(self, f"task{i}_expert{j}") for j in range(self.num_specific)]
                 + [getattr(self, f"task{i}_gate")] for i in range(self.num_tasks)]
        mods = shared + [m for task in tasks for m in task]
        first = (dot_f32(inputs, torch.cat([m.kernel0 for m in mods], dim=1))
                 + torch.cat([m.bias0 for m in mods]))
        ys = iter(first.split([m.hidden_units[0] for m in mods], dim=1))
        shared = [m.after_first(next(ys), training, generator) for m in shared]
        outs = []
        for task in tasks:
            *specific, gate = [m.after_first(next(ys), training, generator) for m in task]
            outs.append(pool(torch.stack(shared + specific, dim=-2), gate))  # (B, E, D)
        return outs
