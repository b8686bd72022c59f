"""DLRM-DCNv2: MLPerf Training's recommendation model.

The MLCommons reference (``training/recommendation_v2/torchrec_dlrm``,
Criteo 1TB multi-hot) with DCN-V2's low-rank cross (Wang et al.,
arXiv:2008.13535), at its published widths:

- 13 dense features (``I1`` .. ``I13``, each a (B, 1) input of
  ``dense_inputs``, passed as log(1 + count)) through a bottom MLP of
  512-256-128 with ReLU;
- 26 sum-pooled id columns (``C1`` .. ``C26``), one table each, rows of
  128, each column as wide as its table's fixed hotness
  (``HOTNESS``: 214 ids an example);
- the interaction input [bottom output, the 26 pooled rows in order],
  27 x 128 = 3,456 wide, through three low-rank cross layers of rank 512
  (``nn.LowRankCrossNet``; span ``model.cross``);
- a top MLP of 1024-1024-512-256 with ReLU and a sigmoid unit, clipped
  to [1e-6, 1] as the port's other heads are, under binary cross-entropy
  (``cross_entropy_sum_mean``: the batch mean).

The tables take the port's row-wise lazy AdaGrad (K9: ``g2sum += mean(g
** 2)``), torchrec's ``EXACT_ROW_WISE_ADAGRAD``, whose eps (added to the
square root of an accumulator that starts at 0) is taken as an initial
``g2sum`` of its square; the dense params take the port's dense Adam.
Every table is a storage of its own: a 128-wide row does not share a
128-lane packing, and a table of 10 M rows indexes its storage in 32 bits
(the kernels' limit, ``embedding/packed.py``).  ``rows`` gives each
table's rows as a deployment holds them (the published ``ROWS`` by
default).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..core.device import resolve_device
from ..embedding import EmbeddingFeatures, category_column, embedding_column
from ..embedding.optimizers import SparseAdaGrad
from ..nn import Dense, LowRankCrossNet, MultiLayerDense
from ..train import losses as L
from ..train import metrics as M
from ..train.adam import Adam
from ..utils.spans import span
from .autoint import clip
from .base import ModelBundle, check_compute_dtype, or_float32, register_model

TASK = "click"
DENSE_KEYS = tuple(f"I{i}" for i in range(1, 14))
TABLES = tuple(f"C{i}" for i in range(1, 27))
ROWS = (40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000, 3067956, 405282,
        10, 2209, 11938, 155, 4, 976, 14, 40000000, 40000000, 40000000, 590152, 12973, 108,
        36)
HOTNESS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3, 1, 1)
DIM = 128
BOTTOM = (512, 256, 128)
TOP = (1024, 1024, 512, 256)
CROSS_RANK, CROSS_LAYERS = 512, 3
SPARSE_LR, INITIAL_G2SUM = 0.005, 1e-16
DENSE_LR = 1e-3


class DLRMDCNv2(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        width = (len(TABLES) + 1) * DIM
        self.bottom = MultiLayerDense(len(DENSE_KEYS), BOTTOM, "relu", device=device)
        self.cross = LowRankCrossNet(width, CROSS_RANK, CROSS_LAYERS, device=device)
        self.top = MultiLayerDense(width, TOP, "relu", device=device)
        self.logit = Dense(TOP[-1], 1, "sigmoid", device=device)

    def forward(self, embs: Dict[str, torch.Tensor], training: bool = False, seed: int = 0,
                dense_inputs=None) -> Dict[str, torch.Tensor]:
        x = self.bottom(torch.cat([dense_inputs[k] for k in DENSE_KEYS], dim=1))
        z = torch.cat([x] + [embs[t] for t in TABLES], dim=1)
        with span("model.cross"):
            z = self.cross(z)
        return {TASK: clip(self.logit(self.top(z)))}


@register_model("dlrm_dcnv2")
def create_dlrm_dcnv2(rows: Optional[Sequence[int]] = None,
                      table_dtype=None,
                      compute_dtype=None,
                      num_shards: int = 1,
                      device="cuda") -> ModelBundle:
    """The DLRM-DCNv2 bundle on ``device`` (raises where CUDA is absent
    unless ``device="cpu"``).  ``rows``: each of the 26 tables' rows, in
    ``TABLES`` order (default ``ROWS``, the published counts, 204,184,588
    rows); each table is a storage of its own.  Row-wise lazy AdaGrad at
    ``SPARSE_LR`` from ``INITIAL_G2SUM`` on the tables, Adam(``DENSE_LR``,
    0.9, 0.999, 1e-8) on the dense params.  ``table_dtype``,
    ``compute_dtype`` and ``num_shards`` as in ``create_autoint``."""
    compute_dtype = check_compute_dtype(compute_dtype)
    dev = resolve_device(device)
    rows = tuple(ROWS if rows is None else rows)
    if len(rows) != len(TABLES):
        raise ValueError(f"rows: {len(rows)} tables' rows for {len(TABLES)} tables")
    cols = [embedding_column(category_column(t, n), DIM, combiner="sum", name=t)
            for t, n in zip(TABLES, rows)]
    emb = EmbeddingFeatures(cols, SparseAdaGrad(learning_rate=SPARSE_LR,
                                                initial_g2sum=INITIAL_G2SUM),
                            num_shards=num_shards, table_dtype=or_float32(table_dtype))
    return ModelBundle(name="dlrm_dcnv2", compute_dtype=compute_dtype,
                       module=DLRMDCNv2(device=dev), embedding=emb, tasks=(TASK,),
                       device=dev, dense_input_keys=DENSE_KEYS,
                       losses={TASK: L.cross_entropy_sum_mean},
                       metrics={TASK: [M.binary_accuracy(), M.auc()]},
                       dense_optimizer=Adam(DENSE_LR, b1=0.9, b2=0.999, eps=1e-8))
