"""AutoInt CTR model.

Counterpart of ``recommendsystem_tpu/models/autoint.py``.  Graph:
per-feature embeddings stacked to (B, F, D) -> InteractingLayer branch
(flattened) + deep MLP branch over the flat concat -> concat ``[deep,
autoint_out]`` -> logits MLP -> clip(1e-6, 1.0).  Submodule names follow the
flax ones (``interacting``, ``mlp``, ``logits``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..core.config import ModelConfig, synthetic_ctr_config
from ..core.device import resolve_device
from ..embedding import EmbeddingFeatures, category_column, embedding_column
from ..nn import InteractingLayer, MultiLayerDense
from .base import ModelBundle, register_model
from .plumbing import slice_wide_rows

TASK = "video_id_rank_skip_model"

DEFAULT_MODEL_PARAM = {
    "interact": {"layer_num": 1, "unit_num": 8, "head_num": 2,
                 "use_dropout": True, "dropout_rate": 0.2, "use_res": True},
    "mlp": {"hidden_units": (32, 16), "activation": "relu"},
    "logits": {"hidden_units": (1,), "activation": "sigmoid"},
}


class AutoIntModule(nn.Module):
    def __init__(self, cfg: ModelConfig, model_param: Any, device=None):
        super().__init__()
        self.cfg = cfg
        widths = sorted({e - s for si in cfg.slot_intervals.values()
                         for s, e in si.intervals})
        if len(widths) != 1:
            raise ValueError(
                f"autoint needs uniform feature emb sizes, got {widths}")
        d = widths[0]
        f = sum(len(si.intervals) for si in cfg.slot_intervals.values())
        p = model_param["interact"]
        self.interacting = InteractingLayer(
            d, layer_num=p["layer_num"], unit_num=p["unit_num"],
            head_num=p["head_num"], use_dropout=p["use_dropout"],
            dropout_rate=p["dropout_rate"], use_res=p["use_res"], device=device)
        mlp_units = tuple(model_param["mlp"]["hidden_units"])
        self.mlp = MultiLayerDense(f * d, mlp_units,
                                   model_param["mlp"]["activation"], device=device)
        deep_width = mlp_units[-1] if mlp_units else f * d
        self.logits = MultiLayerDense(deep_width + f * p["unit_num"],
                                      tuple(model_param["logits"]["hidden_units"]),
                                      model_param["logits"]["activation"],
                                      device=device)

    def forward(self, embs: Dict[str, torch.Tensor],
                training: bool = False) -> Dict[str, torch.Tensor]:
        structure, _, _ = slice_wide_rows(self.cfg, embs)
        all_inputs = torch.stack(structure, dim=1)             # (B, F, D)
        b = all_inputs.shape[0]
        autoint_out = self.interacting(all_inputs, training=training).reshape(b, -1)
        deep = self.mlp(all_inputs.reshape(b, -1))
        output = self.logits(torch.cat([deep, autoint_out], dim=1))
        return {TASK: output.clamp(1e-6, 1.0)}


@register_model("autoint")
def create_autoint(cfg: Optional[ModelConfig] = None,
                   model_param: Optional[dict] = None,
                   bucket_size: int = 265000,
                   device="cuda") -> ModelBundle:
    """The autoint bundle on ``device`` (raises where CUDA is absent unless
    ``device="cpu"``).  Defaults: 24 mean columns of width 8 over
    ``bucket_size``-row tables, grouped into storages of at most 10 MB as in
    the JAX package."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = synthetic_ctr_config(num_slots=24, emb_sizes=(8,), num_bias=0)
    model_param = {**DEFAULT_MODEL_PARAM, **(model_param or {})}

    dim = cfg.max_embed_size
    cols = [embedding_column(category_column(cfg.table_slot(slot), bucket_size),
                             dim, combiner="mean", name=slot)
            for slot in cfg.sparse_slots]
    emb = EmbeddingFeatures(cols, group_tables=True, max_group_bytes=10 << 20)
    return ModelBundle(name="autoint",
                       module=AutoIntModule(cfg, model_param, device=dev),
                       embedding=emb, tasks=(TASK,), device=dev, config=cfg)
