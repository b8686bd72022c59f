"""Plain reference of the staytime configuration (``configs/staytime.json``).

The reference repository's short-video watch-time ranker
(``staytime/config.py:4-16``, ``staytime/VideoDnn.py``, ``staytime/layer.py``):

- every slot's 32-wide row splits into a general half [0:16) and a bias
  half [16:32);
- a DIN pool over each behaviour sequence: a scorer sigmoid([q, f, q - f,
  q * f] W1 + b1) W2 + b2 over each fact of the sequence against its query
  slot's general half, masked positions scored -2**32 + 1, a softmax over
  the sequence, the score-weighted sum of the facts;
- SENet over the concatenated general halves (input detached; squeeze to
  F // 4 ReLU units, excite to F sigmoid gates times 2);
- the user x item product (ReLU), the listwise FM cross term and its logit
  over the reweighted fields, FFM over user x item pairs at width 8;
- the concatenation feeds 3 PPNet-gated experts of (256, 128) (each gate
  ReLU then 2 x sigmoid over the bias halves), 3 MMoE task gates of (64,
  32) and a softmax over the experts, and a 3-layer DeepCross;
- the staytime head: a 400-bin softmax over [task-0 mixture, cross] and
  its expected value over the bin centres (negative values cut to 0); the
  shortplay and longplay heads: a sigmoid over [FM logit, ReLU tower].

Loss: 2 KL(staytime) + 2 CE(shortplay) + CE(longplay), each the sample-
weighted mean; the KL over the first 400 label columns, both sides
clipped to [1e-7, 1].
"""

from __future__ import annotations

from typing import Dict

import torch

from . import common as C

T_STAY = "video_id_rank_staytime_mtl_ppnet_v7_staytime"
T_SHORT = "video_id_rank_staytime_mtl_ppnet_v7_shortplay"
T_LONG = "video_id_rank_staytime_mtl_ppnet_v7_longplay"
MASK_PAD = -(2.0 ** 32) + 1.0


def columns(m: dict):
    """(column key, table key, kind, ids a row) of every column: a mean
    column per slot, and each behaviour sequence on its slot's table."""
    cols = []
    for s in m["slots"]:
        cols.append((s, s, "mean", m["ids_per_column"]))
        if s in m["seq_slots"]:
            cols.append((f"seq_{s}", s, "sequence", m["seq_max_len"]))
    return cols


def tables(m: dict) -> Dict[str, tuple]:
    return {s: (m["bucket_size"], m["dim"]) for s in m["slots"]}


def labels(m: dict) -> Dict[str, str]:
    return {T_STAY: "staytime", T_SHORT: "shortplay", T_LONG: "longplay"}


def din_pool(query, facts, mask, p, name):
    """query (B, H), facts (B, T, H), mask (B, T) -> (B, H)."""
    b, t, h = facts.shape
    q = query[:, None, :].expand(b, t, h)
    feats = torch.cat([q, facts, q - facts, q * facts], dim=-1)
    s = torch.sigmoid(feats @ p[f"{name}.w1"] + p[f"{name}.b1"])
    scores = (s @ p[f"{name}.w2"] + p[f"{name}.b2"]).reshape(b, t)
    scores = torch.where(mask > 0, scores, torch.full_like(scores, MASK_PAD))
    return (torch.softmax(scores, dim=-1)[:, :, None] * facts).sum(dim=1)


def forward(m: dict, p: Dict[str, torch.Tensor], embs: Dict, training: bool = False,
            seed: int = 0, sample0: int = 0) -> Dict[str, torch.Tensor]:
    g = m["general"]
    general = {s: embs[s][:, :g] for s in m["slots"]}
    fields = [general[s] for s in m["slots"]]
    query_of = dict(m["seq_query"])
    din = []
    for s in m["seq_slots"]:
        rows, mask = embs[f"seq_{s}"]
        din.append(din_pool(general[query_of[s]], rows[:, :, :g], mask, p, f"din_{s}"))

    squeeze = C.dense(torch.cat(fields, dim=-1).detach(), p, "senet.senet_squeeze_layer", "relu")
    gates = 2.0 * C.dense(squeeze, p, "senet.senet_extract_layer", "sigmoid")
    reweighted = [e * gates[:, i:i + 1] for i, e in enumerate(fields)]

    mu = torch.cat([general[s] for s in m["user_slots"]], dim=-1)
    mi = torch.cat([general[s] for s in m["item_slots"]], dim=-1)
    product = torch.relu(mu * mi)
    stacked = torch.stack(reweighted, dim=0)
    total = stacked.sum(dim=0)
    cross_term = total * total - (stacked * stacked).sum(dim=0)
    fm_logit = 0.5 * cross_term.sum(dim=-1, keepdim=True)
    fd = m["ffm_dim"]
    ffm = torch.cat([C.dense(general[x], p, f"ffm.ffm_x_{x}_{y}_{fd}")
                     * C.dense(general[y], p, f"ffm.ffm_y_{x}_{y}_{fd}")
                     for x in m["user_slots"] for y in m["item_slots"]], dim=-1)
    concat = torch.cat(reweighted + [cross_term, product, ffm] + din, dim=-1)
    gate_input = torch.cat([embs[s][:, g:] for s in m["bias_slots"]], dim=-1)

    experts = []
    for i in range(m["num_experts"]):
        deep = concat
        for j in range(len(m["deep_hidden_units"])):
            gate = C.dense(gate_input, p, f"gate_{i}_{j}_1", "relu")
            gate = C.dense(gate, p, f"gate_{i}_{j}_2", "sigmoid") * 2
            deep = gate * C.dense(deep, p, f"expert_output_{i}_{j}", "relu")
        experts.append(deep)
    experts = torch.stack(experts, dim=1)                          # (B, E, D)

    mixtures = []
    for i in range(m["num_tasks"]):
        h = concat
        for j in range(len(m["mmoe_units"])):
            h = C.dense(h, p, f"gate_{i}_{j}", "relu")
        weights = C.dense(h, p, f"gate_output_{i}", "softmax")
        mixtures.append(torch.einsum("bed,be->bd", experts, weights))

    cross = concat
    for i in range(m["dcn_layers"]):
        scalar = cross @ p[f"dcn.w_{i}"]
        base = concat if i == 0 else cross
        cross = base * scalar + p[f"dcn.b_{i}"] + cross

    bins = torch.tensor([m["bin_left"] + m["bin_width"] * i for i in range(m["bins"])],
                        dtype=torch.float32, device=concat.device).reshape(-1, 1)
    dist = torch.softmax(C.dense(torch.cat([mixtures[0], cross], dim=-1), p,
                                 "staytime_output"), dim=-1)
    value = dist @ bins
    value = torch.where(value < 0.0, torch.zeros_like(value), value)
    short = C.dense(torch.cat([fm_logit, C.dense(mixtures[1], p, "tower_deep_shortplay", "relu")],
                              dim=1), p, "shortplay_pred", "sigmoid")
    long_ = C.dense(torch.cat([fm_logit, C.dense(mixtures[2], p, "tower_deep_longplay", "relu")],
                              dim=1), p, "longplay_pred", "sigmoid")
    return {T_STAY: torch.cat([dist, value], dim=-1), T_SHORT: short, T_LONG: long_,
            "value": value}


def loss(m: dict, outputs, labels_, weight) -> torch.Tensor:
    n = m["bins"]
    y = C.clip(labels_[T_STAY][:, :n], 1e-7, 1.0)
    q = C.clip(outputs[T_STAY][:, :n], 1e-7, 1.0)
    kl = (y * torch.log(y / q)).sum(dim=-1)
    w = m["loss_weights"]
    return (w[T_STAY] * C.weighted_mean(kl, weight)
            + w[T_SHORT] * C.weighted_mean(C.cross_entropy(labels_[T_SHORT], outputs[T_SHORT]),
                                           weight)
            + w[T_LONG] * C.weighted_mean(C.cross_entropy(labels_[T_LONG], outputs[T_LONG]),
                                          weight))


def predict_view(m: dict, outputs) -> Dict[str, torch.Tensor]:
    return {T_STAY: outputs["value"], T_SHORT: outputs[T_SHORT], T_LONG: outputs[T_LONG]}
