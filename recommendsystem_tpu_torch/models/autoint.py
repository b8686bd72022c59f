"""AutoInt CTR model.

Counterpart of ``recommendsystem_tpu/models/autoint.py``.  Graph:
per-feature embeddings stacked to (B, F, D) -> InteractingLayer branch
(flattened) + deep MLP branch over the flat concat -> concat ``[deep,
autoint_out]`` -> logits MLP -> clip(1e-6, 1.0).  Submodule names follow the
flax ones (``interacting``, ``mlp``, ``logits``).  The clip is
``minimum(maximum(x, lo), hi)``, as ``jnp.clip`` computes it, so that a
sigmoid that saturates to exactly 1.0 passes half its gradient, as in JAX
(``torch.clamp`` would pass all of it).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..core.config import ModelConfig, synthetic_ctr_config
from ..core.device import resolve_device
from ..embedding import EmbeddingFeatures, category_column, embedding_column
from ..embedding.optimizers import SparseAdam
from ..nn import InteractingLayer, MultiLayerDense
from ..train import losses as L
from ..train import metrics as M
from ..train.adam import Adam
from .base import ModelBundle, check_compute_dtype, or_float32, register_model
from .plumbing import slice_wide_rows

TASK = "video_id_rank_skip_model"

DEFAULT_MODEL_PARAM = {
    "interact": {"layer_num": 1, "unit_num": 8, "head_num": 2,
                 "use_dropout": True, "dropout_rate": 0.2, "use_res": True},
    "mlp": {"hidden_units": (32, 16), "activation": "relu"},
    "logits": {"hidden_units": (1,), "activation": "sigmoid"},
}


def clip(x: torch.Tensor, lo: float = 1e-6, hi: float = 1.0) -> torch.Tensor:
    """``jnp.clip`` as JAX computes it, min(max(x, lo), hi): at a tie with
    a bound the gradient splits in half.  The bounds are filled on x's
    device (``new_tensor`` would copy them from the host, a sync each) and
    in x's dtype, as JAX's Python-float bounds are weak scalars that take
    x's type (PyTorch would not promote a bf16 x against a 0-d float32
    bound; JAX would against a float32 array)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


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

    def forward(self, embs: Dict[str, torch.Tensor], training: bool = False,
                seed: int = 0) -> Dict[str, torch.Tensor]:
        structure, _, _ = slice_wide_rows(self.cfg, embs)
        all_inputs = torch.stack(structure, dim=1)             # (B, F, D)
        b = all_inputs.shape[0]
        autoint_out = self.interacting(all_inputs, training=training,
                                       seed=seed).reshape(b, -1)
        deep = self.mlp(all_inputs.reshape(b, -1))
        output = self.logits(torch.cat([deep, autoint_out], dim=1))
        return {TASK: clip(output)}


@register_model("autoint")
def create_autoint(cfg: Optional[ModelConfig] = None,
                   model_param: Optional[dict] = None,
                   bucket_size: int = 265000,
                   table_dtype=None,
                   compute_dtype=None,
                   opt_state_dtype=None,
                   sparse_lr: float = 5e-5,
                   dense_lr: float = 5e-5,
                   device="cuda") -> ModelBundle:
    """The autoint bundle on ``device`` (raises where CUDA is absent unless
    ``device="cpu"``).  Defaults: 24 mean columns of width 8 over
    ``bucket_size``-row tables, grouped into storages of at most 10 MB as in
    the JAX package; lazy per-row Adam on the tables and Adam(5e-5, 0.9,
    0.999, 1e-8) on the dense tower (the reference's learning rates,
    ``models/autoint.py:70-113`` of the JAX package); loss
    ``cross_entropy_sum_mean``.  ``table_dtype`` (None: float32, bfloat16
    or ``"auto"``) stores the tables, ``opt_state_dtype`` (None: float32,
    or bfloat16) Adam's moments; ``compute_dtype`` (None: float32, or
    bfloat16) is the dense tower's compute dtype, the JAX package's
    mixed-precision policy (``train.step.apply_model``); any other raises
    ``ValueError`` (``base.check_compute_dtype``)."""
    compute_dtype = check_compute_dtype(compute_dtype)
    dev = resolve_device(device)
    if cfg is None:
        cfg = synthetic_ctr_config(num_slots=24, emb_sizes=(8,), num_bias=0)
    model_param = {**DEFAULT_MODEL_PARAM, **(model_param or {})}

    dim = cfg.max_embed_size
    cols = [embedding_column(category_column(cfg.table_slot(slot), bucket_size),
                             dim, combiner="mean", name=slot)
            for slot in cfg.sparse_slots]
    emb = EmbeddingFeatures(cols, SparseAdam(learning_rate=sparse_lr,
                                             state_dtype=or_float32(opt_state_dtype)),
                            group_tables=True, max_group_bytes=10 << 20,
                            table_dtype=or_float32(table_dtype))
    return ModelBundle(name="autoint", compute_dtype=compute_dtype,
                       module=AutoIntModule(cfg, model_param, device=dev),
                       embedding=emb, tasks=(TASK,), device=dev, config=cfg,
                       losses={TASK: L.cross_entropy_sum_mean},
                       metrics={TASK: [M.binary_accuracy(), M.auc(), M.copc()]},
                       dense_optimizer=Adam(dense_lr, b1=0.9, b2=0.999,
                                            eps=1e-8))
