"""Shared feature plumbing for wide shared-slot rows.

Counterpart of ``recommendsystem_tpu/models/plumbing.py``: every slot is
pulled at ONE physical width (the max total emb size over slots); each
feature then reads its own ``[start, end)`` interval of its slot's row; bias
features are routed by ``bias_type``; gate features are the listed slots.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..core.config import ModelConfig


def slice_wide_rows(cfg: ModelConfig, embs: Dict[str, torch.Tensor],
                    gate_slots: Sequence[str] = ()) -> Tuple[
                        List[torch.Tensor], Dict[str, List[torch.Tensor]],
                        List[torch.Tensor]]:
    """embs: slot_id -> (B, max_embed_size) wide row.

    Returns (emb_structure_input, emb_bias_input, emb_gate_input):
    structure/gate follow ``cfg.slot_intervals`` insertion order; bias
    groups iterate slots SORTED."""
    structure: List[torch.Tensor] = []
    gate: List[torch.Tensor] = []
    for slot, si in cfg.slot_intervals.items():
        for s in si.intervals:
            piece = embs[slot][:, s[0]:s[1]]
            structure.append(piece)
            if slot in gate_slots:
                gate.append(piece)

    bias: Dict[str, List[torch.Tensor]] = {}
    for slot in sorted(cfg.bias_intervals.keys()):
        for bias_type, (s, e) in cfg.bias_intervals[slot].items():
            bias.setdefault(bias_type, []).append(embs[slot][:, s:e])
    return structure, bias, gate
