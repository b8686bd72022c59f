"""Staytime multi-task model, the richest model of the zoo.

Counterpart of ``recommendsystem_tpu/models/staytime.py`` (the reference's
``staytime/VideoDnn.py``, ``config.py`` and ``model.py``).  Graph: 32-d slot
embeddings split into general [0:16) and bias [16:) halves; DIN pooling
(K7) over 3 behaviour sequences keyed to query slots (in the predict step
each sequence comes as a ``SequenceRows`` handle and K7 gathers its general
half from the table); SENet (concat squeeze) over the general halves;
user x item multiply; listwise FM; FFM
user x item pairs at dim 8; all concatenated; 3 PPNet-gated experts over
(256, 128); 3-task MMoE gates (64, 32); the staytime head, DeepCross(3) and
a 400-bin softmax whose expected value over the bin centres is the served
score (train output: the distribution and the value, (B, 401)); the
shortplay and longplay sigmoid heads fused with the FM logit.

Submodules and parameters carry the flax names (``din_2125``, ``senet``,
``ffm``, ``gate_{i}_{j}_{1,2}``, ``expert_output_{i}_{j}``, ``gate_{i}_{j}``,
``gate_output_{i}``, ``dcn``, ``staytime_output``, ``tower_deep_*``,
``*_pred``), so a flattened flax tree is the module's state dict.  Sparse
AdaGrad (5e-3) on the tables and dense Adam (5e-4) on the tower, losses
KL(2.0) + CE(2.0) + CE(1.0), with sample weights; the packed train step
updates the tables by the lazy AdaGrad pass K9.  ``stacked_experts`` builds the three PPNet-gated
experts as one stack ``experts`` (each kernel (3, in, out), as the JAX
``stacked_gated_experts`` leaves them).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core.device import resolve_device
from ..embedding import EmbeddingFeatures, category_column, embedding_column
from ..embedding.optimizers import SparseAdaGrad
from ..embedding.packed import SequenceRows
from ..nn import (DINPool, DeepCrossLayer, Dense, FFMBlock, SENet, dot_f32, einsum_f32,
                  fm_cross_term, stacked_gated_experts)
from ..train import losses as L
from ..train import metrics as M
from ..train.adam import Adam
from .base import ModelBundle, check_compute_dtype, or_float32, register_model

MULTICLASS_NUM = 400
BIN_LIST = tuple(-19.0 + 0.5 * i for i in range(MULTICLASS_NUM))

T_STAY = "video_id_rank_staytime_mtl_ppnet_v7_staytime"
T_SHORT = "video_id_rank_staytime_mtl_ppnet_v7_shortplay"
T_LONG = "video_id_rank_staytime_mtl_ppnet_v7_longplay"

GENERAL = 16          # width of the general half of a slot's row
MMOE_UNITS = (64, 32)


@dataclasses.dataclass(frozen=True)
class StaytimeConfig:
    """Slot groups of the reference's ``staytime/config.py:4-16`` and
    ``VideoDnn.py:32-35``."""

    slots: Tuple[str, ...] = tuple(str(s) for s in (
        1568, 1570, 1571, 1574, 1575, 1576, 1577, 1578, 1579, 1581, 1582, 1583,
        1585, 1587, 1589, 1591, 1592, 1593, 1594, 1595, 1599, 1601,
        1611, 1612, 1614, 1616, 1623, 1636, 1736, 1737, 1738,
        1739, 1740, 1741, 1743, 1744, 1749, 2039, 2040, 2041, 2042, 2043, 2044,
        2050, 2051, 2052, 2123, 2125, 2127, 2128, 2130, 2131,
        2135, 2139, 2142, 2144, 2147, 2149, 2151, 2152,
        2154, 2156, 2544,
        2597, 3051, 3365, 3369, 3376, 3370,
        1745, 2045, 1632, 1735, 2153, 2047, 2244, 2046, 2150, 2247, 1625, 1624,
        2148, 2159, 2146, 2242, 2260, 2155, 2259, 2615, 4500, 4386))
    seq_slots: Tuple[str, ...] = ("2125", "2128", "2130")
    user_slots: Tuple[str, ...] = ("1568", "1589", "2039", "1570")
    item_slots: Tuple[str, ...] = ("1591", "1593", "1737", "1614")
    bias_slots: Tuple[str, ...] = ("3051", "1570", "2039", "2544", "1568", "3376",
                                   "3365", "3369", "2597", "1737", "1593", "1591",
                                   "1589", "1614")
    # seq slot -> query slot (VideoDnn.py:69-76)
    seq_query: Tuple[Tuple[str, str], ...] = (("2125", "1591"), ("2128", "1593"),
                                              ("2130", "1737"))
    seq_max_len: int = 50
    num_experts: int = 3
    num_tasks: int = 3
    dim: int = 32
    bucket_size: int = 81920


class StaytimeModule(nn.Module):
    def __init__(self, cfg: StaytimeConfig,
                 deep_hidden_units: Tuple[int, ...] = (256, 128),
                 stacked_experts: bool = False, device=None):
        super().__init__()
        self.cfg = cfg
        self.stacked_experts = stacked_experts
        self.deep_hidden_units = tuple(deep_hidden_units)
        c = cfg
        for s in c.seq_slots:
            setattr(self, f"din_{s}", DINPool(GENERAL, device=device))
        self.senet = SENet(len(c.slots), GENERAL, squeeze="concat", device=device)
        self.ffm = FFMBlock(((c.user_slots, c.item_slots, 8),),
                            {s: GENERAL for s in c.user_slots + c.item_slots},
                            device=device)
        concat_width = (GENERAL * (len(c.slots) + 1 + len(c.user_slots)
                                   + len(c.seq_slots))
                        + 8 * len(c.user_slots) * len(c.item_slots))
        gate_width = (c.dim - GENERAL) * len(c.bias_slots)
        if stacked_experts:
            self.experts = stacked_gated_experts(c.num_experts, self.deep_hidden_units,
                                                 concat_width, gate_width, device=device)
        else:
            for i in range(c.num_experts):
                width = concat_width
                for j, unit in enumerate(self.deep_hidden_units):
                    setattr(self, f"gate_{i}_{j}_1", Dense(gate_width, unit, "relu",
                                                           device=device))
                    setattr(self, f"gate_{i}_{j}_2", Dense(unit, unit, "sigmoid",
                                                           device=device))
                    setattr(self, f"expert_output_{i}_{j}",
                            Dense(width, unit, "relu", device=device))
                    width = unit
        expert_width = self.deep_hidden_units[-1]
        for i in range(c.num_tasks):
            width = concat_width
            for j, unit in enumerate(MMOE_UNITS):
                setattr(self, f"gate_{i}_{j}", Dense(width, unit, "relu", device=device))
                width = unit
            setattr(self, f"gate_output_{i}",
                    Dense(width, c.num_experts, "softmax", device=device))
        self.dcn = DeepCrossLayer(concat_width, num_layer=3, device=device)
        self.staytime_output = Dense(expert_width + concat_width, MULTICLASS_NUM,
                                     None, device=device)
        self.tower_deep_shortplay = Dense(expert_width, 1, "relu", device=device)
        self.shortplay_pred = Dense(2, 1, "sigmoid", device=device)
        self.tower_deep_longplay = Dense(expert_width, 1, "relu", device=device)
        self.longplay_pred = Dense(2, 1, "sigmoid", device=device)
        self.register_buffer("bins", torch.tensor(BIN_LIST, dtype=torch.float32,
                                                  device=device).reshape(-1, 1),
                             persistent=False)

    def forward(self, embs: Dict, training: bool = False,
                seed: int = 0) -> Dict[str, torch.Tensor]:
        c = self.cfg
        general = {s: embs[s][:, 0:GENERAL] for s in c.slots}
        general_inputs = [general[s] for s in c.slots]
        bias_inputs = [embs[s][:, GENERAL:] for s in c.bias_slots]

        # DIN over the behaviour sequences (K7)
        seq_query = dict(c.seq_query)
        din_embs = []
        for s in c.seq_slots:
            seq = embs[f"seq_{s}"]
            if isinstance(seq, SequenceRows):    # predict: K7 gathers the rows
                facts, seq_mask = seq.lanes(0, GENERAL), None
            else:
                seq_emb, seq_mask = seq
                facts = seq_emb[:, :, 0:GENERAL]
            din_embs.append(getattr(self, f"din_{s}")(general[seq_query[s]], facts,
                                                      seq_mask))

        general_reweight = self.senet(general_inputs)
        mu = torch.cat([general[s] for s in c.user_slots], dim=-1)
        mi = torch.cat([general[s] for s in c.item_slots], dim=-1)
        multiply_result = torch.relu(mu * mi)
        cross_term, fm_logit = fm_cross_term(general_reweight)
        ffm = self.ffm(general)

        concated = torch.cat(general_reweight + [cross_term, multiply_result, ffm]
                             + din_embs, dim=-1)
        gate_input = torch.cat(bias_inputs, dim=-1)

        # PPNet-gated experts
        if self.stacked_experts:
            experts = self.experts(concated, gate_input).transpose(0, 1)   # (B, E, D)
        else:
            expert_outs = []
            for i in range(c.num_experts):
                deep = concated
                for j in range(len(self.deep_hidden_units)):
                    gate = getattr(self, f"gate_{i}_{j}_1")(gate_input)
                    gate = getattr(self, f"gate_{i}_{j}_2")(gate) * 2
                    deep = gate * getattr(self, f"expert_output_{i}_{j}")(deep)
                expert_outs.append(deep)
            experts = torch.stack(expert_outs, dim=1)              # (B, E, D)

        # MMoE gates
        mmoe_outs = []
        for i in range(c.num_tasks):
            g = concated
            for j in range(len(MMOE_UNITS)):
                g = getattr(self, f"gate_{i}_{j}")(g)
            g = getattr(self, f"gate_output_{i}")(g)
            mmoe_outs.append(einsum_f32("bed,be->bd", experts, g))

        # staytime: 400-bin distribution and its expected value
        cross_feature = self.dcn(concated)
        st_logits = self.staytime_output(torch.cat([mmoe_outs[0], cross_feature], dim=-1))
        st_dist = torch.softmax(st_logits, dim=-1)
        st_pred = dot_f32(st_dist, self.bins)
        st_pred = torch.where(st_pred < 0.0, torch.zeros_like(st_pred), st_pred)
        st_train = torch.cat([st_dist, st_pred], dim=-1)

        # shortplay / longplay fused with the FM logit
        sp = self.shortplay_pred(torch.cat(
            [fm_logit, self.tower_deep_shortplay(mmoe_outs[1])], dim=1))
        lp = self.longplay_pred(torch.cat(
            [fm_logit, self.tower_deep_longplay(mmoe_outs[2])], dim=1))
        return {T_STAY: st_train, T_SHORT: sp, T_LONG: lp, f"{T_STAY}_pred": st_pred}


@register_model("staytime")
def create_staytime(cfg: Optional[StaytimeConfig] = None,
                    deep_hidden_units: Tuple[int, ...] = (256, 128),
                    stacked_experts: bool = False,
                    table_dtype=None,
                    compute_dtype=None,
                    sparse_lr: float = 5e-3,
                    dense_lr: float = 5e-4,
                    num_shards: int = 1,
                    device="cuda") -> ModelBundle:
    """The staytime bundle on ``device`` (raises where CUDA is absent unless
    ``device="cpu"``).  Defaults: 91 mean columns of width 32 over
    81,920-id buckets and 3 sequence columns of 50 that share the tables of
    their slots, grouped into storages of at most 30 MB as in the JAX
    package (45 table pairs and one single table); ``stacked_experts``
    stacks the three gated experts.  ``table_dtype`` (None: float32,
    bfloat16 or ``"auto"``, which stores these 32-wide rows in bf16) stores
    the tables (AdaGrad's g2sum stays float32); ``compute_dtype`` as in
    ``create_autoint``.
    ``num_shards`` pads every storage for that many ranks of the sharded
    mode, as the JAX factory does."""
    compute_dtype = check_compute_dtype(compute_dtype)
    dev = resolve_device(device)
    cfg = cfg or StaytimeConfig()
    cols = []
    for s in cfg.slots:
        cat = category_column(s, cfg.bucket_size)
        cols.append(embedding_column(cat, cfg.dim, combiner="mean"))
        if s in cfg.seq_slots:
            cols.append(embedding_column(cat, cfg.dim, combiner=None,
                                         seq_max_len=cfg.seq_max_len,
                                         name=f"seq_{s}"))
    emb = EmbeddingFeatures(cols, SparseAdaGrad(learning_rate=sparse_lr,
                                                initial_g2sum=0.1,
                                                initial_scale=0.1),
                            num_shards=num_shards, group_tables=True, max_group_bytes=30 << 20,
                            table_dtype=or_float32(table_dtype))
    return ModelBundle(
        name="staytime", compute_dtype=compute_dtype,
        module=StaytimeModule(cfg, deep_hidden_units, stacked_experts, device=dev),
        embedding=emb, tasks=(T_STAY, T_SHORT, T_LONG), device=dev, config=cfg,
        predict_outputs={T_STAY: f"{T_STAY}_pred", T_SHORT: T_SHORT, T_LONG: T_LONG},
        losses={T_STAY: L.kl_loss, T_SHORT: L.cross_entropy_elementwise,
                T_LONG: L.cross_entropy_elementwise},
        loss_weights={T_STAY: 2.0, T_SHORT: 2.0, T_LONG: 1.0},
        metrics={T_STAY: [M.bin_accuracy(BIN_LIST), M.ev_mae(), M.ev_mse()],
                 T_SHORT: [M.binary_accuracy(), M.auc()],
                 T_LONG: [M.binary_accuracy(), M.auc()]},
        dense_optimizer=Adam(dense_lr, b1=0.9, b2=0.999, eps=1e-8))
