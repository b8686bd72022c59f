"""Plain reference of the DLRM-DCNv2 configuration (``configs/dlrm_dcnv2.json``).

MLPerf Training's recommendation model (MLCommons
``training/recommendation_v2/torchrec_dlrm``) with DCN-V2's low-rank cross
(Wang et al., arXiv:2008.13535):

- the 13 dense features ``I1`` .. ``I13`` (each (B, 1), log(1 + count))
  through a bottom MLP (ReLU after every layer);
- each of the 26 id columns ``C1`` .. ``C26`` the sum of its masked rows
  (a column as wide as its table's hotness; ``columns`` gives it a kind
  other than ``"mean"``, so the driver hands over the masked rows and the
  mask, and the sum is taken here);
- x0 = [bottom output, the 26 sums in order]; three cross layers
  ``x_{l+1} = x0 * ((x_l @ V_l) @ W_l + b_l) + x_l``;
- a top MLP (ReLU) and a sigmoid unit clipped to [1e-6, 1].

Loss: the binary cross-entropy with 1e-6 inside the logarithms, the batch
mean.  The parameters carry the program's names (``bottom.dense_<i>``,
``cross.v_<i>``, ``cross.w_<i>``, ``cross.b_<i>``, ``top.dense_<i>``,
``logit``), as the harness hands both sides the same weights.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import common as C

TASK = "click"


def columns(m: dict):
    """(column key, table key, kind, ids a row): one sum-pooled column a
    table, as wide as its hotness."""
    return [(t, t, "sum", h) for t, h in zip(m["tables"], m["hotness"])]


def tables(m: dict) -> Dict[str, tuple]:
    return {t: (m[f"rows_{t}"], m["dim"]) for t in m["tables"]}


def labels(m: dict) -> Dict[str, str]:
    return {TASK: "click"}


def dense(m: dict) -> Dict[str, int]:
    """The dense features' keys and widths: ``I1`` .. ``I13``, one count
    each."""
    return {f"I{i}": 1 for i in range(1, m["dense_features"] + 1)}


def forward(m: dict, p: Dict[str, torch.Tensor], embs: Dict, training: bool = False,
            seed: int = 0, sample0: int = 0, dense=None) -> Dict[str, torch.Tensor]:
    x = torch.cat([dense[f"I{i}"] for i in range(1, m["dense_features"] + 1)], dim=1)
    for i in range(len(m["bottom"])):
        x = C.dense(x, p, f"bottom.dense_{i}", "relu")
    x0 = torch.cat([x] + [embs[t][0].sum(dim=1) for t in m["tables"]], dim=1)
    xl = x0
    for i in range(m["cross_layers"]):
        u = (xl @ p[f"cross.v_{i}"]) @ p[f"cross.w_{i}"] + p[f"cross.b_{i}"]
        xl = x0 * u + xl
    z = xl
    for i in range(len(m["top"]) - 1):
        z = C.dense(z, p, f"top.dense_{i}", "relu")
    return {TASK: C.clip(C.dense(z, p, "logit", "sigmoid"), 1e-6, 1.0)}


def loss(m: dict, outputs, labels_, weight) -> torch.Tensor:
    return C.cross_entropy(labels_[TASK], outputs[TASK]).sum(dim=1).mean(dim=0)


def predict_view(m: dict, outputs) -> Dict[str, torch.Tensor]:
    return {TASK: outputs[TASK]}
