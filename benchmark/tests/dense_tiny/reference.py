"""Plain reference of the tests' dense configuration (``config.json``
beside it): the dense features, (B, 13) log(1 + count), through a bottom
MLP (ReLU); beside them each id column's masked mean; the two
concatenated into a top MLP (ReLU) and a sigmoid unit clipped to
[1e-6, 1].  Loss: the cross-entropy summed over the label axis, then the
batch mean."""

from __future__ import annotations

from typing import Dict

import torch

from reference import common as C

TASK = "click"


def columns(m: dict):
    return [(s, s, "mean", m["ids_per_column"]) for s in m["slots"]]


def tables(m: dict) -> Dict[str, tuple]:
    return {s: (m["bucket_size"], m["dim"]) for s in m["slots"]}


def labels(m: dict) -> Dict[str, str]:
    return {TASK: "click"}


def dense(m: dict) -> Dict[str, int]:
    """The dense features' keys and widths: one key of all the counts."""
    return {"counts": m["dense_features"]}


def forward(m: dict, p: Dict[str, torch.Tensor], embs: Dict, training: bool = False,
            seed: int = 0, sample0: int = 0, dense=None) -> Dict[str, torch.Tensor]:
    x = dense["counts"]
    for i in range(len(m["bottom"])):
        x = C.dense(x, p, f"bottom.dense_{i}", "relu")
    z = torch.cat([x] + [embs[s] for s in m["slots"]], dim=1)
    for i in range(len(m["top"])):
        z = C.dense(z, p, f"top.dense_{i}", "relu")
    return {TASK: C.clip(C.dense(z, p, "logit", "sigmoid"), 1e-6, 1.0)}


def loss(m: dict, outputs, labels_, weight) -> torch.Tensor:
    return C.cross_entropy(labels_[TASK], outputs[TASK]).sum(dim=1).mean(dim=0)


def predict_view(m: dict, outputs) -> Dict[str, torch.Tensor]:
    return {TASK: outputs[TASK]}
