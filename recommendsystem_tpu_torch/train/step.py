"""Predict step of the port.

Counterpart of the predict half of ``recommendsystem_tpu/train/step.py``:
fused embedding lookup (``embedding/packed.py::lookup_packed``), then the
dense tower in float32, then the bundle's ``predict_view``.  The train and
eval steps come with slice 2.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import functional_call

from ..embedding import packed as packed_mod
from ..models.base import ModelBundle
from .state import TrainState


def apply_model(bundle: ModelBundle, params, embs, dense_inputs=None,
                training: bool = False):
    """Apply the bundle's module to ``params`` in float32 (the bf16 compute
    policy comes with a later slice)."""
    kwargs = {}
    if dense_inputs is not None:
        kwargs["dense_inputs"] = dense_inputs
    return functional_call(bundle.module, params, (embs,),
                           {"training": training, **kwargs})


def _lookup_for_mode(bundle, tables, batch, mode: str = "local"):
    if mode != "local":
        raise NotImplementedError(f"lookup mode {mode!r}: the sharded modes "
                                  f"come with a later slice of the port")
    return packed_mod.lookup_packed(bundle.embedding, tables, batch)


def make_predict_step(bundle: ModelBundle, mode: str = "local") -> Callable:
    """Returns ``step(state, batch, dense_inputs) -> {task: (B, 1)}``,
    running under ``torch.inference_mode()``; ``batch`` holds IdBatches of
    tensors on the bundle's device."""

    def step(state: TrainState, batch, dense_inputs=None):
        with torch.inference_mode():
            embs = _lookup_for_mode(bundle, state.tables, batch, mode)
            outputs = apply_model(bundle, state.params, embs, dense_inputs,
                                  training=False)
            return bundle.predict_view(outputs)

    return step
