"""The program side of the tests' dense configuration: a bundle of the
port's own parts (its embedding engine and lazy Adam, its Dense layers,
its loss and dense Adam) whose tower reads ``dense_inputs``, for the
factory name ``bench_dense_tiny`` (``create``)."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from recommendsystem_tpu_torch.core.device import resolve_device
from recommendsystem_tpu_torch.embedding import (EmbeddingFeatures, category_column,
                                                 embedding_column)
from recommendsystem_tpu_torch.embedding.optimizers import SparseAdam
from recommendsystem_tpu_torch.models.autoint import clip
from recommendsystem_tpu_torch.models.base import ModelBundle
from recommendsystem_tpu_torch.nn import Dense, MultiLayerDense
from recommendsystem_tpu_torch.train import losses as L
from recommendsystem_tpu_torch.train.adam import Adam

TASK = "click"
SLOTS = ("a", "b", "c")
DIM, DENSE, BOTTOM, TOP = 8, 13, (16, 8), (16,)


class DenseTiny(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.bottom = MultiLayerDense(DENSE, BOTTOM, "relu", device=device)
        self.top = MultiLayerDense(BOTTOM[-1] + len(SLOTS) * DIM, TOP, "relu", device=device)
        self.logit = Dense(TOP[-1], 1, "sigmoid", device=device)

    def forward(self, embs: Dict[str, torch.Tensor], training: bool = False, seed: int = 0,
                dense_inputs=None) -> Dict[str, torch.Tensor]:
        x = self.bottom(dense_inputs["counts"])
        z = self.top(torch.cat([x] + [embs[s] for s in SLOTS], dim=1))
        return {TASK: clip(self.logit(z))}


def create(bucket_size: int = 1000, num_shards: int = 1, device="cuda") -> ModelBundle:
    dev = resolve_device(device)
    cols = [embedding_column(category_column(s, bucket_size), DIM, combiner="mean", name=s)
            for s in SLOTS]
    emb = EmbeddingFeatures(cols, SparseAdam(learning_rate=5e-5), num_shards=num_shards)
    return ModelBundle(name="bench_dense_tiny", module=DenseTiny(device=dev), embedding=emb,
                       tasks=(TASK,), device=dev, dense_input_keys=("counts",),
                       losses={TASK: L.cross_entropy_sum_mean},
                       dense_optimizer=Adam(5e-5, b1=0.9, b2=0.999, eps=1e-8))
