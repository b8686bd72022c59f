"""Finish-rate DeepFM with a bias-gated deep tower.

Counterpart of ``recommendsystem_tpu/models/finish.py`` (the reference's
``rank/finish/videodnn.py``).  Graph: 32-d slot embeddings; the general
and bias slots read lanes [0:16) of their rows, and the first bias slot's
tail [16:) joins the general concat; ``DeepFMLayer`` (order-2 + linear)
over the general concat; the deep tower (64, 32), whose input from layer 1
on is multiplied by a bias-tower gate ``2 * sigmoid(Dense(relu(Dense(bias))))``,
and one more gate after the loop; concat(deep, FM) -> Dense(1, sigmoid).
L1L2(1e-5, 1e-5) on every deep and bias-tower kernel.  Sparse and dense
Adam 1e-3, ``cross_entropy_sum_mean`` on the one task.

Submodules carry the flax names (``fm`` with ``weight`` and
``deeepfmlinear``, ``dnn_{i}``, ``bais_dnn_one_{i}``, ``bais_dnn_two_{i}``
with the reference's spelling, ``pred``), so a flattened flax tree is the
module's state dict.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.device import resolve_device
from ..embedding import EmbeddingFeatures, category_column, embedding_column
from ..embedding.optimizers import SparseAdam
from ..nn import DeepFMLayer, Dense
from ..train import losses as L
from ..train import metrics as M
from ..train.adam import Adam
from .base import ModelBundle, check_compute_dtype, or_float32, register_model

TASK = "video_id_rank_finish_nb_lr_rongh_bundle"
REG = (1e-5, 1e-5)
LANES = 16            # the general and bias slots read [0:16) of their rows


class DeepFMModule(nn.Module):
    def __init__(self, bias_slots: Tuple[str, ...], general_slots: Tuple[str, ...],
                 wide_tail_slot: Optional[str], dim: int = 32,
                 deep_hidden_units: Tuple[int, ...] = (64, 32), device=None):
        super().__init__()
        self.bias_slots = tuple(bias_slots)
        self.general_slots = tuple(general_slots)
        self.wide_tail_slot = wide_tail_slot
        self.deep_hidden_units = tuple(deep_hidden_units)
        general = LANES * len(self.general_slots) + (
            dim - LANES if wide_tail_slot is not None else 0)
        bias = LANES * len(self.bias_slots)

        def dense(name, *args, **kwargs):
            setattr(self, name, Dense(*args, device=device, **kwargs))

        self.fm = DeepFMLayer(general, device=device)
        width = general
        for i, unit in enumerate(self.deep_hidden_units):
            if i > 0:
                dense(f"bais_dnn_one_{i}", bias, width, "relu", kernel_regularizer=REG)
                dense(f"bais_dnn_two_{i}", width, width, "sigmoid", kernel_regularizer=REG)
            dense(f"dnn_{i}", width, unit, "relu", kernel_regularizer=REG)
            width = unit
        dense("bais_dnn_one_3", bias, width, "relu", kernel_regularizer=REG)
        dense("bais_dnn_two_3", width, width, "sigmoid", kernel_regularizer=REG)
        dense("pred", width + 1, 1, "sigmoid")

    def _gate(self, i: int, bias: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"bais_dnn_two_{i}")(getattr(self, f"bais_dnn_one_{i}")(bias)) * 2

    def forward(self, embs: Dict[str, torch.Tensor], training: bool = False,
                seed: int = 0) -> Dict[str, torch.Tensor]:
        general = [embs[s][:, 0:LANES] for s in self.general_slots]
        if self.wide_tail_slot is not None:
            general.append(embs[self.wide_tail_slot][:, LANES:])
        general = torch.cat(general, dim=1)
        fm = self.fm(general)
        bias = torch.cat([embs[s][:, 0:LANES] for s in self.bias_slots], dim=1)

        x = general
        for i in range(len(self.deep_hidden_units)):
            if i > 0:
                x = x * self._gate(i, bias)
            x = getattr(self, f"dnn_{i}")(x)
        x = x * self._gate(3, bias)
        return {TASK: self.pred(torch.cat([x, fm], dim=1))}


@register_model("finish")
def create_finish(slots: Optional[Sequence[str]] = None,
                  bias_slots: Optional[Sequence[str]] = None,
                  bucket_size: int = 25600,
                  dim: int = 32,
                  deep_hidden_units: Tuple[int, ...] = (64, 32),
                  table_dtype=None,
                  compute_dtype=None,
                  opt_state_dtype=None,
                  sparse_lr: float = 1e-3,
                  dense_lr: float = 1e-3,
                  num_shards: int = 1,
                  device="cuda") -> ModelBundle:
    """The finish bundle on ``device`` (raises where CUDA is absent unless
    ``device="cpu"``).  Defaults as the JAX package's: slots ``3000..3039``
    of ``dim`` 32 over ``bucket_size``-id buckets, the bias slots the first
    8, tables grouped into storages of at most 4 MB (one table each), lazy
    per-row Adam (1e-3) on the tables and Adam(1e-3) on the tower;
    ``table_dtype``, ``opt_state_dtype`` and ``compute_dtype`` as in
    ``create_autoint``.
    ``num_shards`` pads every storage for that many ranks of the sharded
    mode, as the JAX factory does."""
    compute_dtype = check_compute_dtype(compute_dtype)
    dev = resolve_device(device)
    if slots is None:
        slots = [str(s) for s in range(3000, 3040)]
    if bias_slots is None:
        bias_slots = tuple(slots[:8])
    wide_tail = bias_slots[0] if bias_slots else None
    general = tuple(s for s in slots if s not in set(bias_slots))
    cols = [embedding_column(category_column(s, bucket_size), dim, combiner="mean")
            for s in slots]
    emb = EmbeddingFeatures(cols, SparseAdam(learning_rate=sparse_lr,
                                             state_dtype=or_float32(opt_state_dtype)),
                            num_shards=num_shards, group_tables=True, max_group_bytes=4 << 20,
                            table_dtype=or_float32(table_dtype))
    return ModelBundle(
        name="finish", compute_dtype=compute_dtype,
        module=DeepFMModule(tuple(bias_slots), general, wide_tail, dim,
                            tuple(deep_hidden_units), device=dev),
        embedding=emb, tasks=(TASK,), device=dev,
        losses={TASK: L.cross_entropy_sum_mean},
        metrics={TASK: [M.binary_accuracy(), M.auc()]},
        dense_optimizer=Adam(dense_lr, b1=0.9, b2=0.999, eps=1e-8))
