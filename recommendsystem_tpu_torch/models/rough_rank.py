"""Rough-rank (pre-rank) DSSM with PLE towers and teacher distillation.

Counterpart of ``recommendsystem_tpu/models/rough_rank.py`` (the
reference's ``rough_rank/model.py``).  Graph: the user tower is a PLE (2
tasks, 4 shared and 4 specific experts of DNN(32)) over the user slots,
then a linear DNN(16) per task (``td_emb``, ``hpld_emb``), chosen per
sample by the dense flag ``4575``: ``where(flag == 1, hpld, td)``; the
item tower a PLE (1 task) and DNN(16) ``emb``; the teacher CrossNet(2) ‖
Dense(128, relu) → Dense(64, relu) over every slot, then Dense(16) →
Dense(1), a logit; the student Dense(32, relu) → Dense(1) over [user_emb ‖
item_emb]; the distillation term the per-sample squared distance of the
student's logit from the teacher's, the teacher's taken as a constant
(``jax.lax.stop_gradient`` in the reference, ``detach`` here).  Slots are
concatenated in ``sorted()`` string order.  Losses: BCE on the student's
and the teacher's sigmoid, plus the mean distillation term; sparse Adam
1e-3 on the tables (16-d mean columns over 25,600-id buckets, storages of
at most 4 MB), dense Adam 1e-4.

Submodules carry the flax names (``sub_model_user.ple``,
``sub_model_user.td_emb``, ``sub_model_item.emb``, ``teacher_cross``,
``teacher_d128``, ``shallow_dnn_0``, ``logit_shallow``, ...), so a
flattened flax tree is the module's state dict.  The flag comes in
``dense_inputs`` (the serving path fills 0 where a request has none); the
2-task user tower needs it, as the JAX tower built with it does.
``stacked_experts`` swaps the PLEs for ``PLEStacked``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.device import resolve_device
from ..embedding import EmbeddingFeatures, category_column, embedding_column
from ..embedding.optimizers import SparseAdam
from ..nn import DNN, PLE, CrossNet, Dense, PLEStacked, kd_loss
from ..train import losses as L
from ..train import metrics as M
from ..train.adam import Adam
from .base import ModelBundle, check_compute_dtype, or_float32, register_model

FLAG_SLOT = "4575"
TASK_NAMES = ("td", "hpld")


class _Tower(nn.Module):
    """PLE, then a linear DNN(``output_dim``) per task; with 2 tasks the
    flag chooses between them per sample."""

    def __init__(self, in_features: int, num_tasks: int, output_dim: int = 16,
                 stacked_experts: bool = False, device=None):
        super().__init__()
        self.num_tasks = num_tasks
        ple = PLEStacked if stacked_experts else PLE
        self.ple = ple(in_features, num_tasks=num_tasks, num_shared_experts=4,
                       num_specific_experts=4, expert_dnn_units=(32,),
                       gate_dnn_units=(), device=device)
        if num_tasks == 2:
            for t in TASK_NAMES:
                setattr(self, f"{t}_emb", DNN(32, (output_dim,), output_activation="linear",
                                              device=device))
        else:
            self.emb = DNN(32, (output_dim,), output_activation="linear", device=device)

    def forward(self, x: torch.Tensor, flag: Optional[torch.Tensor] = None,
                training: bool = False) -> torch.Tensor:
        outs = self.ple(x, training)
        if self.num_tasks != 2:
            return self.emb(outs[0], training)
        if flag is None:
            raise ValueError(f"the 2-task user tower needs the dense flag {FLAG_SLOT!r} "
                             f"in dense_inputs")
        td, hpld = (getattr(self, f"{t}_emb")(o, training)
                    for t, o in zip(TASK_NAMES, outs))
        return torch.where((flag == 1).reshape(-1, 1), hpld, td)


class DSSMModule(nn.Module):
    def __init__(self, user_slots: Tuple[str, ...], item_slots: Tuple[str, ...],
                 dim: int = 16, user_output_dim: int = 16, item_output_dim: int = 16,
                 stacked_experts: bool = False, device=None):
        super().__init__()
        self.user_slots = tuple(sorted(user_slots))
        self.item_slots = tuple(sorted(item_slots))
        self.all_slots = tuple(sorted(set(user_slots) | set(item_slots)))
        width = len(self.all_slots) * dim
        self.sub_model_user = _Tower(len(self.user_slots) * dim, 2, user_output_dim,
                                     stacked_experts, device=device)
        self.sub_model_item = _Tower(len(self.item_slots) * dim, 1, item_output_dim,
                                     stacked_experts, device=device)
        self.teacher_cross = CrossNet(width, layer_num=2, device=device)
        self.teacher_d128 = Dense(width, 128, "relu", device=device)
        self.teacher_d64 = Dense(128, 64, "relu", device=device)
        self.teacher_d16 = Dense(64 + width, 16, device=device)
        self.pred_teacher = Dense(16, 1, device=device)
        self.shallow_dnn_0 = Dense(user_output_dim + item_output_dim, 32, "relu",
                                   device=device)
        self.logit_shallow = Dense(32, 1, device=device)

    def forward(self, embs: Dict[str, torch.Tensor], training: bool = False, seed: int = 0,
                dense_inputs: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        flag = (dense_inputs or {}).get(FLAG_SLOT)
        user_concat = torch.cat([embs[s] for s in self.user_slots], dim=-1)
        item_concat = torch.cat([embs[s] for s in self.item_slots], dim=-1)
        all_concat = torch.cat([embs[s] for s in self.all_slots], dim=-1)
        user_emb = self.sub_model_user(user_concat, flag, training)
        item_emb = self.sub_model_item(item_concat, training=training)

        # teacher
        cross = self.teacher_cross(all_concat)
        deep = self.teacher_d64(self.teacher_d128(all_concat))
        teacher_logit = self.pred_teacher(self.teacher_d16(torch.cat([deep, cross], dim=-1)))

        # student shallow tower
        sdeep = self.shallow_dnn_0(torch.cat([user_emb, item_emb], dim=-1))
        student_logit = self.logit_shallow(sdeep)

        kd = kd_loss(student_logit, teacher_logit.detach())
        return {"student": torch.sigmoid(student_logit),
                "teacher": torch.sigmoid(teacher_logit),
                "distill": kd[:, None],
                "user_emb": user_emb,
                "item_emb": item_emb}


@register_model("rough_rank")
def create_rough_rank(user_slots: Optional[Sequence[str]] = None,
                      item_slots: Optional[Sequence[str]] = None,
                      bucket_size: int = 25600,
                      dim: int = 16,
                      stacked_experts: bool = False,
                      table_dtype=None,
                      compute_dtype=None,
                      opt_state_dtype=None,
                      sparse_lr: float = 1e-3,
                      dense_lr: float = 1e-4,
                      num_shards: int = 1,
                      device="cuda") -> ModelBundle:
    """The rough_rank bundle on ``device`` (raises where CUDA is absent
    unless ``device="cpu"``).  Defaults as the JAX package's: user slots
    ``1560..1589``, item slots ``1591..1609``, one mean column of ``dim``
    16 a slot over ``bucket_size``-id buckets, tables grouped into storages
    of at most 4 MB (24 of 51,296 rows and one of 25,648 at the defaults),
    lazy per-row Adam (1e-3) on the tables and Adam(1e-4) on the tower;
    ``table_dtype``, ``opt_state_dtype`` and ``compute_dtype`` as in
    ``create_autoint``.
    ``num_shards`` pads every storage for that many ranks of the sharded
    mode, as the JAX factory does."""
    compute_dtype = check_compute_dtype(compute_dtype)
    dev = resolve_device(device)
    if user_slots is None:
        user_slots = [str(s) for s in range(1560, 1590)]
    if item_slots is None:
        item_slots = [str(s) for s in range(1591, 1610)]
    all_slots = sorted(set(user_slots) | set(item_slots))
    cols = [embedding_column(category_column(s, bucket_size), dim, combiner="mean")
            for s in all_slots]
    emb = EmbeddingFeatures(cols, SparseAdam(learning_rate=sparse_lr,
                                             state_dtype=or_float32(opt_state_dtype)),
                            num_shards=num_shards, group_tables=True, max_group_bytes=4 << 20,
                            table_dtype=or_float32(table_dtype))
    return ModelBundle(
        name="rough_rank", compute_dtype=compute_dtype,
        module=DSSMModule(tuple(user_slots), tuple(item_slots), dim,
                          stacked_experts=stacked_experts, device=dev),
        embedding=emb, tasks=("student", "teacher"), device=dev,
        losses={"student": L.binary_cross_entropy,
                "teacher": L.binary_cross_entropy,
                "distill": L.y_pred_loss},
        metrics={"student": [M.binary_accuracy(), M.auc(), M.ctr(), M.copc()],
                 "teacher": [M.binary_accuracy(), M.auc(), M.ctr(), M.copc()]},
        dense_optimizer=Adam(dense_lr, b1=0.9, b2=0.999, eps=1e-8),
        dense_input_keys=(FLAG_SLOT,),
        predict_outputs={"student": "student", "teacher": "teacher",
                         "user_emb": "user_emb", "item_emb": "item_emb"})
