"""Mixture-of-experts layers with their experts' parameters stacked.

Counterpart of ``recommendsystem_tpu/nn/moe_stacked.py``: the same math as
``nn/moe.py``'s MMOE and PLE and as the gated experts of ctr and staytime,
with the experts' parameters on a leading axis, as flax's ``nn.vmap``
leaves them (``experts.kernel0`` of shape (E, in, out)), so a flattened
flax tree is the layer's state dict.  The experts run as one batched
product a layer (``DNN(stack=E)``, ``Dense(stack=E)``) instead of E small
ones.  A stacked layer's L1L2 penalty is summed over its experts, as the
JAX step sums every leaf of the sown losses.

Expert parallelism: ``expert_shardings`` places every stacked leaf's
expert axis over the model axis of a 2-D mesh, as the JAX function does.
Given E/M of a stack's E experts (in a sharded step under the model axis,
``core.model_axis``), ``GatedExpert``, ``MMOEStacked`` and ``PLEStacked``
compute their rank's experts from ``copy_to_model`` of their inputs (and
of the gate input), then all-gather the experts' outputs on the expert
axis (``gather_from_model``), so the gates and towers after them see all E
experts as before; the backward sums the inputs' gradients over the model
group and keeps each rank's experts' own.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from ..core.mesh import MODEL_AXIS, Mesh, expert_sharding, replicated
from ..core.model_axis import copy_to_model, gather_from_model
from .mlp import DNN, Dense
from .moe import _gate_params, pool

EXPERT_KEYS = ("experts", "specific_experts")


def expert_shardings(params: Dict[str, torch.Tensor], mesh: Mesh, axis: str = MODEL_AXIS):
    """The placement of every leaf of a flat param dict (``recommendsystem_tpu/
    nn/moe_stacked.py:145-163``): a leaf of two dims or more with a name
    segment ``experts`` or ``specific_experts`` gets ``"expert"`` (its
    leading axis split over the model axis), every other leaf
    ``"replicated"``.  A stack whose expert count the model axis does not
    divide raises ``ValueError``, as the JAX ``device_put`` refuses it.
    Merge into a state's placements with ``train.state.merge_shardings``."""
    if axis != MODEL_AXIS:
        raise ValueError(f"expert_shardings: axis {axis!r}; the port's mesh has "
                         f"{MODEL_AXIS!r}")
    out = {}
    for name, x in params.items():
        if any(seg in EXPERT_KEYS for seg in name.split(".")[:-1]) and x.ndim >= 2:
            if x.shape[0] % mesh.model:
                raise ValueError(f"{name}: {x.shape[0]} experts do not split over a model "
                                 f"axis of {mesh.model}")
            out[name] = expert_sharding(mesh)
        else:
            out[name] = replicated(mesh)
    return out


def _expert_reads(module: nn.Module, prefix: str = "") -> Dict[str, str]:
    return {f"{prefix}{name}": "expert" for name, _ in module.named_parameters()}


def _split(leaf: torch.Tensor, n: int) -> bool:
    """Whether a stack whose first parameter is ``leaf`` holds a shard of
    its ``n`` experts."""
    return leaf.shape[0] < n


class MMOEStacked(nn.Module):
    """``MMOE`` with its experts stacked: ``experts`` (a DNN of E) and
    ``task{i}_gate``."""

    def __init__(self, in_features: int, num_tasks: int, num_experts: int = 2,
                 expert_dnn_units: Sequence[int] = (32,),
                 gate_dnn_units: Sequence[int] = (),
                 expert_dnn_params: Optional[Dict[str, Any]] = None,
                 gate_dnn_params: Optional[Dict[str, Any]] = None, device=None):
        super().__init__()
        self.num_tasks, self.num_experts = num_tasks, num_experts
        gate_units = list(gate_dnn_units) + [num_experts]
        self.experts = DNN(in_features, expert_dnn_units, stack=num_experts,
                           device=device, **(expert_dnn_params or {}))
        for i in range(num_tasks):
            setattr(self, f"task{i}_gate", DNN(in_features, gate_units, device=device,
                                               **_gate_params(gate_dnn_params)))

    def model_axis_reads(self) -> Dict[str, str]:
        return _expert_reads(self.experts, "experts.")

    def forward(self, inputs: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        if _split(self.experts.kernel0, self.num_experts):
            experts = gather_from_model(self.experts(copy_to_model(inputs), training,
                                                     generator), 0)
        else:
            experts = self.experts(inputs, training, generator)
        experts = experts.transpose(0, 1)                                   # (B, E, D)
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
        self.num_shared = num_shared_experts
        gate_units = list(gate_dnn_units) + [num_shared_experts + num_specific_experts]
        self.experts = DNN(in_features, expert_dnn_units, stack=num_shared_experts,
                           device=device, **(expert_dnn_params or {}))
        self.specific_experts = DNN(in_features, expert_dnn_units,
                                    stack=num_tasks * num_specific_experts,
                                    device=device, **(expert_dnn_params or {}))
        for i in range(num_tasks):
            setattr(self, f"task{i}_gate", DNN(in_features, gate_units, device=device,
                                               **_gate_params(gate_dnn_params)))

    def model_axis_reads(self) -> Dict[str, str]:
        return {**_expert_reads(self.experts, "experts."),
                **_expert_reads(self.specific_experts, "specific_experts.")}

    def forward(self, inputs: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        stacks = []
        for stack, n in ((self.experts, self.num_shared),
                         (self.specific_experts, self.num_tasks * self.num_specific)):
            if _split(stack.kernel0, n):
                out = gather_from_model(stack(copy_to_model(inputs), training, generator), 0)
            else:
                out = stack(inputs, training, generator)
            stacks.append(out.transpose(0, 1))
        shared, specific = stacks                                           # (B, S, D)
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
        self.n, self.stack = len(hidden), stack
        for j, unit in enumerate(hidden):
            setattr(self, f"gate_{j}_1", Dense(gate_features, unit, "relu",
                                               stack=stack, device=device))
            setattr(self, f"gate_{j}_2", Dense(unit, unit, "sigmoid",
                                               stack=stack, device=device))
            setattr(self, f"expert_output_{j}", Dense(in_features, unit, "relu",
                                                      stack=stack, device=device))
            in_features = unit

    def model_axis_reads(self) -> Dict[str, str]:
        return {} if self.stack is None else _expert_reads(self)

    def forward(self, expert_in: torch.Tensor, gate_input: torch.Tensor) -> torch.Tensor:
        split = self.stack is not None and _split(self.gate_0_1.kernel, self.stack)
        if split:
            expert_in, gate_input = copy_to_model(expert_in), copy_to_model(gate_input)
        expert = expert_in
        for j in range(self.n):
            g = 2 * getattr(self, f"gate_{j}_2")(getattr(self, f"gate_{j}_1")(gate_input))
            expert = g * getattr(self, f"expert_output_{j}")(expert)
        return gather_from_model(expert, 0) if split else expert


def stacked_gated_experts(num_experts: int, hidden: Sequence[int], in_features: int,
                          gate_features: int, device=None) -> GatedExpert:
    """The stack of ``num_experts`` gated experts that the JAX
    ``stacked_gated_experts`` builds (a model keeps it as ``experts``).
    Calling it on (B, in) and (B, G) gives (E, B, D): the JAX function's
    (B, E, D) is its ``transpose(0, 1)``."""
    return GatedExpert(in_features, gate_features, tuple(hidden), stack=num_experts,
                       device=device)
