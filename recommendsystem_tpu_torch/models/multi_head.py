"""7-task multi-head interaction ranker.

Counterpart of ``recommendsystem_tpu/models/multi_head.py`` (the
reference's ``rank/multi_head/multidnn.py``).  Graph: 8-d slot embeddings
-> (B, F, 8) -> InteractingLayer (1 layer, 8 units, 2 heads, dropout 0.2,
res) + a deep MLP (32, 16) over the flattened stack -> concat -> 8 experts
Dense(32, relu, truncated normal 0.001, L2 0.01) of which the FIRST 7 are
used -> 7 softmax gates Dense(7) -> per-task weighted expert sum -> the 7
sigmoid heads of ``TASKS``.  Sparse Adam 5e-5, dense Adam 1e-5,
``cross_entropy_per_sample`` on every head.

Parameters carry the flax names (``interacting``, ``dnn_{i}``,
``expert_{i}_fc1``, ``gate_{i}_fc2``, one Dense per task name), so a
flattened flax tree is the module's state dict.  The L1L2 penalties are
stored on their Dense layers; the train step adds them to the loss.
``stacked_experts`` builds the 8 experts as one stacked Dense
``experts_fc1`` (kernel (8, in, 32), as the JAX ``nn.vmap`` leaves it), of
which the first 7 outputs are used; its L2 penalty covers all 8.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.device import resolve_device
from ..embedding import EmbeddingFeatures, category_column, embedding_column
from ..embedding.optimizers import SparseAdam
from ..nn import Dense, InteractingLayer, einsum_f32, truncated_normal
from ..train import losses as L
from ..train import metrics as M
from ..train.adam import Adam
from .base import ModelBundle, check_compute_dtype, or_float32, register_model

TASKS = ("like_pred", "click_comment_pred", "comment_pred", "click_sharing_pred",
         "follow_pred", "click_avatar_pred", "unlike_pred")

_TN_INIT = truncated_normal(0.001)
_EXPERT_REG = (0.0, 0.01)
DEEP_UNITS = (32, 16)
EXPERT_NUM = 7


class MultiHeadModule(nn.Module):
    def __init__(self, slots: Tuple[str, ...], dim: int = 8, stacked_experts: bool = False,
                 device=None):
        super().__init__()
        self.slots = tuple(slots)
        self.stacked_experts = stacked_experts
        f = len(self.slots)
        self.interacting = InteractingLayer(
            dim, layer_num=1, unit_num=8, head_num=2, use_dropout=True,
            dropout_rate=0.2, use_res=True, device=device)
        width = f * dim
        for i, unit in enumerate(DEEP_UNITS):
            setattr(self, f"dnn_{i}", Dense(width, unit, "relu",
                                            kernel_regularizer=(1e-5, 1e-5),
                                            device=device))
            width = unit
        result_width = width + 8 * f
        # 8 experts built, the first 7 consumed (the reference's multidnn.py:82-92)
        if stacked_experts:
            self.experts_fc1 = Dense(result_width, 32, "relu", kernel_init=_TN_INIT,
                                     kernel_regularizer=_EXPERT_REG, stack=EXPERT_NUM + 1,
                                     device=device)
        else:
            for idx in range(EXPERT_NUM + 1):
                setattr(self, f"expert_{idx}_fc1", Dense(
                    result_width, 32, "relu", kernel_init=_TN_INIT,
                    kernel_regularizer=_EXPERT_REG, device=device))
        for idx, task in enumerate(TASKS):
            setattr(self, f"gate_{idx}_fc2", Dense(
                result_width, EXPERT_NUM, "softmax", kernel_init=_TN_INIT,
                kernel_regularizer=_EXPERT_REG, device=device))
            setattr(self, task, Dense(32, 1, "sigmoid", device=device))

    def forward(self, embs: Dict[str, torch.Tensor], training: bool = False,
                seed: int = 0) -> Dict[str, torch.Tensor]:
        all_inputs = torch.stack([embs[s] for s in self.slots], dim=1)   # (B, F, 8)
        b = all_inputs.shape[0]
        autoint_out = self.interacting(all_inputs, training=training,
                                       seed=seed).reshape(b, -1)
        deep = all_inputs.reshape(b, -1)
        for i in range(len(DEEP_UNITS)):
            deep = getattr(self, f"dnn_{i}")(deep)
        result = torch.cat([deep, autoint_out], dim=1)
        if self.stacked_experts:
            experts = self.experts_fc1(result)[:EXPERT_NUM].transpose(0, 1)  # (B, 7, 32)
        else:
            experts = torch.stack([getattr(self, f"expert_{idx}_fc1")(result)
                                   for idx in range(EXPERT_NUM)], dim=1)  # (B, 7, 32)
        outputs = {}
        for idx, task in enumerate(TASKS):
            gate = getattr(self, f"gate_{idx}_fc2")(result)                # (B, 7)
            pooled = einsum_f32("bed,be->bd", experts, gate)
            outputs[task] = getattr(self, task)(pooled)
        return outputs


@register_model("multi_head")
def create_multi_head(slots: Optional[Sequence[str]] = None,
                      bucket_size: int = 265000,
                      dim: int = 8,
                      stacked_experts: bool = False,
                      table_dtype=None,
                      compute_dtype=None,
                      opt_state_dtype=None,
                      sparse_lr: float = 5e-5,
                      dense_lr: float = 1e-5,
                      device="cuda") -> ModelBundle:
    """The multi_head bundle on ``device`` (raises where CUDA is absent
    unless ``device="cpu"``).  Defaults as the JAX package's: 40 sorted
    slots ``2000..2039`` of ``dim`` 8 over ``bucket_size``-row tables,
    grouped into storages of at most 10 MB, lazy per-row Adam (5e-5) on the
    tables and Adam(1e-5) on the tower; ``stacked_experts`` stacks the 8
    experts; ``table_dtype``, ``opt_state_dtype`` and ``compute_dtype`` as
    in ``create_autoint``."""
    compute_dtype = check_compute_dtype(compute_dtype)
    dev = resolve_device(device)
    if slots is None:
        slots = [str(s) for s in range(2000, 2040)]
    slots = tuple(sorted(set(slots)))        # the reference sorts (multidnn.py:216-218)
    cols = [embedding_column(category_column(s, bucket_size), dim, combiner="mean")
            for s in slots]
    emb = EmbeddingFeatures(cols, SparseAdam(learning_rate=sparse_lr,
                                             state_dtype=or_float32(opt_state_dtype)),
                            group_tables=True, max_group_bytes=10 << 20,
                            table_dtype=or_float32(table_dtype))
    return ModelBundle(
        name="multi_head", compute_dtype=compute_dtype,
        module=MultiHeadModule(slots, dim, stacked_experts, device=dev),
        embedding=emb, tasks=TASKS, device=dev,
        losses={t: L.cross_entropy_per_sample for t in TASKS},
        metrics={t: [M.binary_accuracy(), M.auc(), M.copc()] for t in TASKS},
        dense_optimizer=Adam(dense_lr, b1=0.9, b2=0.999, eps=1e-8))
