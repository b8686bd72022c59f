"""Plain reference of the autoint configuration (``configs/autoint.json``).

AutoInt (Song et al., CIKM 2019, arXiv:1810.11921) as the reference
repository builds it: each of F mean-combined columns gives a D-wide
field embedding, stacked to (B, F, D); one InteractingLayer iteration
(ReLU projections to U units split into H heads, softmax over the keys
scaled by sqrt(U / H), dropout on the attention weights in training, a
ReLU residual projection, ReLU, LayerNorm over the units with eps 1e-3);
beside it an MLP over the flat fields; the two concatenated into a
sigmoid unit clipped to [1e-6, 1].  Loss: the cross-entropy summed over
the label axis, then the batch mean (sample weights do not enter).
"""

from __future__ import annotations

from typing import Dict

import torch

from . import common as C

TASK = "video_id_rank_skip_model"


def columns(m: dict):
    """(column key, table key, kind, ids a row) of every column."""
    return [(s, s, "mean", m["ids_per_column"]) for s in m["slots"]]


def tables(m: dict) -> Dict[str, tuple]:
    return {s: (m["bucket_size"], m["dim"]) for s in m["slots"]}


def labels(m: dict) -> Dict[str, str]:
    return {TASK: "click"}


def _attention(q, k, v, seed: int, rate: float, sample0: int):
    """q, k, v (H, dh, F, B) -> (H, dh, F, B)."""
    h, dh, f, b = q.shape
    p = torch.softmax(torch.einsum("hdfb,hdgb->hfgb", q, k) / (dh ** 0.5), dim=2)
    if rate > 0.0:
        p = p * C.dropout_scale(h, f, b, seed, rate, q.device, sample0)
    return torch.einsum("hfgb,hdgb->hdfb", p, v)


def interacting(x: torch.Tensor, p: Dict[str, torch.Tensor], m: dict, training: bool,
                seed: int, sample0: int) -> torch.Tensor:
    """(B, F, D) -> (B, F, U), in the (D, F, B) layout the dropout bits
    are numbered in."""
    cfg = m["interact"]
    u, h = cfg["unit_num"], cfg["head_num"]
    rate = cfg["dropout_rate"] if training else 0.0
    x_t = x.permute(2, 1, 0)
    for i in range(cfg["layer_num"]):
        d, f, b = x_t.shape
        flat = x_t.reshape(d, f * b)

        def proj(w, bias):
            return torch.relu(p[w].t() @ flat + p[bias][:, None])

        q, k, v = (proj(w, bias).reshape(h, u // h, f, b)
                   for w, bias in (("interacting.wq", "interacting.bq"),
                                   ("interacting.wk", "interacting.bk"),
                                   ("interacting.wv", "interacting.bv")))
        o = _attention(q, k, v, (seed << 32) | i, rate, sample0).reshape(u, f, b)
        if cfg["use_res"]:
            o = o + proj("interacting.wr", "interacting.br").reshape(u, f, b)
        o = torch.relu(o)
        mu = o.mean(dim=0, keepdim=True)
        var = (o - mu).square().mean(dim=0, keepdim=True)
        x_t = ((o - mu) * torch.rsqrt(var + cfg["ln_epsilon"])
               * p["interacting.ln_scale"][:, None, None] + p["interacting.ln_bias"][:, None, None])
    return x_t.permute(2, 1, 0)


def forward(m: dict, p: Dict[str, torch.Tensor], embs: Dict, training: bool = False,
            seed: int = 0, sample0: int = 0) -> Dict[str, torch.Tensor]:
    x = torch.stack([embs[s] for s in m["slots"]], dim=1)            # (B, F, D)
    b = x.shape[0]
    att = interacting(x, p, m, training, seed, sample0).reshape(b, -1)
    deep = x.reshape(b, -1)
    for i in range(len(m["mlp"])):
        deep = C.dense(deep, p, f"mlp.dense_{i}", "relu")
    out = C.dense(torch.cat([deep, att], dim=1), p, "logits.dense_0", "sigmoid")
    return {TASK: C.clip(out, 1e-6, 1.0)}


def loss(m: dict, outputs, labels_, weight) -> torch.Tensor:
    return C.cross_entropy(labels_[TASK], outputs[TASK]).sum(dim=1).mean(dim=0)


def predict_view(m: dict, outputs) -> Dict[str, torch.Tensor]:
    return {TASK: outputs[TASK]}

