"""CTR production model: SENet + AutoInt + PPNet + MMoE + CAN.

Counterpart of ``recommendsystem_tpu/models/ctr.py`` (the reference's
``rank/ctr/model_init.py`` on the feature machinery of ``base_model.py``).
Graph: SENet (mean squeeze, reduction 4) reweights the per-feature interval
slices; each reweighted slice maps through a linear Dense(8) into the
(B, F, 8) InteractingLayer (1 layer, 8 units, 2 heads, attention dropout
``attention_dropout_rate``, res); the PPNet gate bank 2*sigmoid(Dense(704))
split by ``PPNET_SPLITS``; the gated deep tower (32, 16) with L1L2(1e-5);
the user x item multiply of the bias groups; the CAN micro-net whose
weights a Dense(8*6 + 6 + 6*4 + 4) makes from the can-bias embeddings;
MMoE: 3 experts (512, 256) with per-layer 2*sigmoid gates over the
gate-feature concat, 2 task gates (256, 32) -> softmax(3); the per-task
output MLP (64, 8) with PPNet gates and the CAN tail; sigmoid, then
clip(1e-6, 1).  Sparse and dense Adam 5e-5, ``cross_entropy_sum_mean`` on
both tasks.

Submodules and parameters carry the flax names (``senet``,
``emb_linear_map_{i}``, ``interacting``, ``ppnet.dnn_ppnet_gate``,
``dnn_{i}``, ``dnn_can``, ``gate_{i}_{j}_{1,2}``, ``expert_output_{i}_{j}``,
``gate_{i}_{j}``, ``gate_output_{i}``, ``task{i}_dnn2_{j}``,
``task{i}_out``), so a flattened flax tree is the module's state dict.  The
L1L2 penalties are stored on their Dense layers; the train step adds them
to the loss.  ``stacked_experts`` builds the three gated experts as one
stack (``experts.gate_{j}_{1,2}``, ``experts.expert_output_{j}``, each
kernel (3, in, out), as the JAX ``stacked_gated_experts`` leaves them),
run as one batched product a layer.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core.config import ModelConfig, load_model_parameter_json, synthetic_ctr_config
from ..core.device import resolve_device
from ..embedding import EmbeddingFeatures, category_column, embedding_column
from ..embedding.optimizers import SparseAdam
from ..nn import (Dense, InteractingLayer, PPNetGateBank, SENet, einsum_f32,
                  stacked_gated_experts)
from ..train import losses as L
from ..train import metrics as M
from ..train.adam import Adam
from .autoint import clip
from .base import ModelBundle, check_compute_dtype, or_float32, register_model
from .plumbing import slice_wide_rows

T_CLICK = "video_id_rank_hp_ctr_addfeasetwo_click"
T_EFFECT = "video_id_rank_hp_ctr_addfeasetwo_effect_click"
TASKS = (T_CLICK, T_EFFECT)
REG = (1e-5, 1e-5)
PPNET_SPLITS = (256, 64, 8, 256, 64, 8, 32, 16)
CAN_WIDTH = 8 * 6 + 6 + 6 * 4 + 4
# the reference's widths (``model_init.py``); the PPNet splits and the CAN
# tail are cut for these
DEEP_UNITS = (32, 16)
EXPERT_UNITS = (512, 256)
GATE_UNITS = (256, 32)
OUTPUT_UNITS = (64, 8)
NUM_EXPERTS = 3

# the production gate-feature slot list (the reference's
# ``rank/ctr/base_model.py:135``; the duplicate '1578' is the reference's,
# used only for membership)
REFERENCE_GATE_SLOTS = ('1568', '1570', '1578', '1591', '1593', '1614',
                        '1736', '1737', '2039', '2599', '3051', '3303',
                        '3389', '1576', '1577', '1578')


class CTRModule(nn.Module):
    def __init__(self, cfg: ModelConfig, gate_slots: Tuple[str, ...],
                 attention_dropout_rate: float = 0.2, stacked_experts: bool = False,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.gate_slots = tuple(gate_slots)
        self.stacked_experts = stacked_experts

        structure = [e - s for si in cfg.slot_intervals.values() for s, e in si.intervals]
        gate_width = sum(e - s for slot, si in cfg.slot_intervals.items()
                         if slot in self.gate_slots for s, e in si.intervals)
        bias: Dict[str, int] = {}
        for slot in sorted(cfg.bias_intervals):
            for bias_type, (s, e) in cfg.bias_intervals[slot].items():
                bias[bias_type] = bias.get(bias_type, 0) + e - s
        f = len(structure)

        def dense(name, *args, **kwargs):
            setattr(self, name, Dense(*args, device=device, **kwargs))

        self.senet = SENet(f, 1, squeeze="mean", reduction=4, device=device)
        for i, width in enumerate(structure):
            dense(f"emb_linear_map_{i}", width, 8)
        self.interacting = InteractingLayer(
            8, layer_num=1, unit_num=8, head_num=2,
            use_dropout=attention_dropout_rate > 0,
            dropout_rate=attention_dropout_rate, use_res=True, device=device)
        self.ppnet = PPNetGateBank(bias["ppnet"], PPNET_SPLITS, device=device)
        width = sum(structure)
        for i, unit in enumerate(DEEP_UNITS):
            dense(f"dnn_{i}", width, unit, kernel_regularizer=REG)
            width = unit
        result_width = width + 8 * f + bias["multiply_user"]
        dense("dnn_can", bias["can"], CAN_WIDTH)
        if stacked_experts:
            self.experts = stacked_gated_experts(NUM_EXPERTS, EXPERT_UNITS, result_width,
                                                 gate_width, device=device)
        else:
            for i in range(NUM_EXPERTS):
                width = result_width
                for j, unit in enumerate(EXPERT_UNITS):
                    dense(f"gate_{i}_{j}_1", gate_width, unit, "relu")
                    dense(f"gate_{i}_{j}_2", unit, unit, "sigmoid")
                    dense(f"expert_output_{i}_{j}", width, unit, "relu")
                    width = unit
        for i in range(len(TASKS)):
            width = result_width
            for j, unit in enumerate(GATE_UNITS):
                dense(f"gate_{i}_{j}", width, unit, "relu")
                width = unit
            dense(f"gate_output_{i}", width, NUM_EXPERTS, "softmax")
        for i in range(len(TASKS)):
            width = EXPERT_UNITS[-1]
            for j, unit in enumerate(OUTPUT_UNITS):
                dense(f"task{i}_dnn2_{j}", width, unit, kernel_regularizer=REG)
                width = unit
            dense(f"task{i}_out", width + 4, 1, "sigmoid")

    def forward(self, embs: Dict[str, torch.Tensor], training: bool = False,
                seed: int = 0) -> Dict[str, torch.Tensor]:
        structure, bias, gate_list = slice_wide_rows(self.cfg, embs, self.gate_slots)
        reweight = self.senet(structure)

        # per-field linear 8-d map -> InteractingLayer (K6 or K5)
        autoint_inputs = torch.stack(
            [getattr(self, f"emb_linear_map_{i}")(e) for i, e in enumerate(reweight)],
            dim=1)
        autoint_out = self.interacting(autoint_inputs, training=training, seed=seed)
        autoint_out = autoint_out.reshape(autoint_out.shape[0], -1)

        ppnet_gates = self.ppnet(torch.cat(bias["ppnet"], dim=1))

        # gated deep tower
        deep = torch.cat(reweight, dim=1)
        for i in range(len(DEEP_UNITS)):
            deep = torch.relu(getattr(self, f"dnn_{i}")(deep) * ppnet_gates[i + 6])

        multiply_result = torch.relu(torch.cat(bias["multiply_user"], dim=1)
                                     * torch.cat(bias["multiply_item"], dim=1))
        result = torch.cat([deep, autoint_out, multiply_result], dim=1)

        # CAN micro-net weights from the can-bias embeddings
        can_raw = self.dnn_can(torch.cat(bias["can"], dim=1))
        w1 = can_raw[:, 0:48].reshape(-1, 8, 6)
        b1 = can_raw[:, 48:54].reshape(-1, 1, 6)
        w2 = can_raw[:, 54:78].reshape(-1, 6, 4)
        b2 = can_raw[:, 78:82].reshape(-1, 1, 4)

        # MMoE experts with per-layer gates over the gate features
        gate_input = torch.cat(gate_list, dim=1)
        if self.stacked_experts:
            experts = self.experts(result, gate_input).transpose(0, 1)  # (B, E, 256)
        else:
            expert_outs = []
            for i in range(NUM_EXPERTS):
                expert = result
                for j in range(len(EXPERT_UNITS)):
                    g = getattr(self, f"gate_{i}_{j}_1")(gate_input)
                    g = 2 * getattr(self, f"gate_{i}_{j}_2")(g)
                    expert = g * getattr(self, f"expert_output_{i}_{j}")(expert)
                expert_outs.append(expert)
            experts = torch.stack(expert_outs, dim=1)               # (B, E, 256)

        outputs = {}
        n_out = len(OUTPUT_UNITS)
        for i, task in enumerate(TASKS):
            g = result
            for j in range(len(GATE_UNITS)):
                g = getattr(self, f"gate_{i}_{j}")(g)
            g = getattr(self, f"gate_output_{i}")(g)
            r = einsum_f32("bed,be->bd", experts, g)
            # per-task output MLP with PPNet gates + CAN tail
            for j in range(n_out):
                if j == 0:
                    r = torch.relu(r * ppnet_gates[i * 3])
                r = getattr(self, f"task{i}_dnn2_{j}")(r)
                r = torch.relu(r * ppnet_gates[i * 3 + j + 1])
                if j == n_out - 1:
                    can = torch.relu(r[:, None, :] @ w1 + b1)
                    can = torch.relu(can @ w2 + b2).squeeze(1)      # (B, 4)
                    r = torch.cat([r, can], dim=1)
            outputs[task] = clip(getattr(self, f"task{i}_out")(r))
        return outputs


@register_model("ctr")
def create_ctr(cfg: Optional[ModelConfig] = None,
               gate_slots: Optional[Tuple[str, ...]] = None,
               bucket_size: int = 265000,
               stacked_experts: bool = False,
               attention_dropout_rate: float = 0.2,
               table_dtype=None,
               compute_dtype=None,
               opt_state_dtype=None,
               sparse_lr: float = 5e-5,
               dense_lr: float = 5e-5,
               device="cuda") -> ModelBundle:
    """The ctr bundle on ``device`` (raises where CUDA is absent unless
    ``device="cpu"``).  Defaults as the JAX package's: the 24-slot
    ``synthetic_ctr_config(num_slots=24, num_bias=8)`` (48-wide rows, F =
    24), gate slots the first 8 sparse slots, ``bucket_size``-row tables
    grouped into storages of at most 40 MB, lazy per-row Adam on the tables
    and Adam(5e-5, 0.9, 0.999, 1e-8) on the tower; ``stacked_experts``
    stacks the MMoE's experts; ``table_dtype``, ``opt_state_dtype`` and
    ``compute_dtype`` as in ``create_autoint``."""
    compute_dtype = check_compute_dtype(compute_dtype)
    dev = resolve_device(device)
    if cfg is None:
        cfg = synthetic_ctr_config(num_slots=24, num_bias=8)
    if gate_slots is None:
        gate_slots = tuple(cfg.sparse_slots[:8])

    dim = cfg.max_embed_size
    # slots mapped to one table share one embedding space
    cols = [embedding_column(category_column(cfg.table_slot(slot), bucket_size),
                             dim, combiner="mean", name=slot)
            for slot in cfg.sparse_slots]
    emb = EmbeddingFeatures(cols, SparseAdam(learning_rate=sparse_lr,
                                             state_dtype=or_float32(opt_state_dtype)),
                            group_tables=True, table_dtype=or_float32(table_dtype))
    # the two tasks share the Metric objects; each task's states are its own
    metrics = [M.binary_accuracy(), M.auc(), M.copc()]
    return ModelBundle(
        name="ctr", compute_dtype=compute_dtype,
        module=CTRModule(cfg, tuple(gate_slots),
                         attention_dropout_rate=attention_dropout_rate,
                         stacked_experts=stacked_experts, device=dev),
        embedding=emb, tasks=TASKS, device=dev, config=cfg,
        losses={T_CLICK: L.cross_entropy_sum_mean, T_EFFECT: L.cross_entropy_sum_mean},
        metrics={T_CLICK: list(metrics), T_EFFECT: list(metrics)},
        dense_optimizer=Adam(dense_lr, b1=0.9, b2=0.999, eps=1e-8))


def production_ctr(model_parameter, **kwargs) -> ModelBundle:
    """The flagship ranker from a ``model_parameter.json`` (a path or its
    parsed dict; the reference's 212-feature config), with the production
    gate-slot list and any ``featureid_to_slot`` remap in the file."""
    cfg = load_model_parameter_json(model_parameter)
    kwargs.setdefault("gate_slots", REFERENCE_GATE_SLOTS)
    return create_ctr(cfg=cfg, **kwargs)
