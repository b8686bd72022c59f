"""Serving export: the L6 serving contract of the port.

Counterpart of ``recommendsystem_tpu/train/export.py``.  The whole predict
function (the fused lookup with sequences deferred, the dense tower under
the bundle's compute dtype, and ``predict_view``'s renaming) exports as a
``torch.export`` program, saved with ``torch.export.save`` and loadable with
no Python model code.  Like the JAX artifact it holds no weights: the
tables' weights and the dense params are its inputs, and come from a
checkpoint (``train/checkpoint.py``).  It is exported at the example
batch's shapes, static as the JAX one is: one artifact per bucket.

The kernels stay in the program: K1, K2, K5f, K6 and K7 are custom ops
(``kernels/_ops.py``), each one opaque node, so the loaded program launches
the card's kernels on CUDA tensors and runs their plain versions on CPU
tensors.  A program exported on a card holds that card's device in its
constants, one exported on the CPU the CPU's.

    blob = export_serving(bundle, state, batch, dense_inputs, path="out")
    serve = load_serving(blob)          # imports the ops first
    scores = serve(weights_of(state), state.params, batch, dense_inputs)
"""

from __future__ import annotations

import io
import json
import os
from typing import Dict, Optional

import torch

from ..embedding.engine import IdBatch
from ..kernels import _ops  # noqa: F401  (registers the ops a program names)
from .state import TrainState
from .step import _lookup_for_mode, apply_model

SERIALIZED_NAME = "recommendsystem_tpu_torch.IdBatch"

# the exported signature takes {column: IdBatch}: register it as a pytree
# node with a serialized name, as the JAX export registers its IdBatch, and
# as a type torch.load may rebuild under weights_only
try:
    torch.export.register_dataclass(IdBatch, serialized_type_name=SERIALIZED_NAME)
except ValueError:
    pass   # already registered
torch.serialization.add_safe_globals([IdBatch])


def weights_of(state: TrainState) -> Dict[str, torch.Tensor]:
    """The served program's table input: {storage: (rows, D) w}."""
    return {skey: t["w"] for skey, t in state.tables.items()}


def make_serving_fn(bundle):
    """``serve(tables_w, params, batch, dense_inputs) -> {task: (B, 1)}``:
    the predict step's body (``train/step.py::make_predict_step``) on
    ``tables_w`` ({storage: w}) and the dense ``params``, without the
    predict step's ``torch.inference_mode()``, which ``torch.export`` does
    not trace through (export under ``torch.no_grad()``)."""

    def serve(tables_w, params, batch, dense_inputs=None):
        tables = {skey: {"w": w} for skey, w in tables_w.items()}
        embs = _lookup_for_mode(bundle, tables, batch)
        outputs = apply_model(bundle, params, embs, dense_inputs, training=False)
        return bundle.predict_view(outputs)

    return serve


class _Serving(torch.nn.Module):
    """The serving function as the module ``torch.export`` takes; it holds
    no parameter or buffer of its own."""

    def __init__(self, bundle):
        super().__init__()
        self._serve = make_serving_fn(bundle)

    def forward(self, tables_w, params, batch, dense_inputs=None):
        return self._serve(tables_w, params, batch, dense_inputs)


def signature(bundle, batch: Dict[str, IdBatch]) -> dict:
    """``signature.json``: the model, its served outputs and each batch
    column's shape, as the JAX ``export_serving`` writes them."""
    names = ({t: None for t in bundle.losses} if not bundle.predict_outputs
             else {src: None for src in bundle.predict_outputs.values()})
    return {"model": bundle.name,
            "outputs": sorted(bundle.predict_view(names).keys()),
            "batch_columns": {k: list(v.rows.shape) for k, v in batch.items()}}


def export_program(bundle, state: TrainState, batch: Dict[str, IdBatch],
                   dense_inputs=None) -> torch.export.ExportedProgram:
    """The predict function exported at the example inputs' shapes, its
    example inputs dropped (they would carry the weights)."""
    detach = lambda tree: {k: v.detach() for k, v in tree.items()}   # noqa: E731
    args = (detach(weights_of(state)), detach(state.params), batch, dense_inputs)
    with torch.no_grad():
        program = torch.export.export(_Serving(bundle), args, strict=False)
    program.example_inputs = None
    return program


def export_serving(bundle, state: TrainState, batch: Dict[str, IdBatch],
                   dense_inputs=None, path: Optional[str] = None) -> bytes:
    """Serialize the predict function at the example batch's shapes.

    Returns the bytes of ``torch.export.save``; with ``path`` also writes
    ``<path>/model.pt2`` and ``<path>/signature.json``."""
    buf = io.BytesIO()
    torch.export.save(export_program(bundle, state, batch, dense_inputs), buf)
    blob = buf.getvalue()
    if path:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "model.pt2"), "wb") as f:
            f.write(blob)
        with open(os.path.join(path, "signature.json"), "w") as f:
            json.dump(signature(bundle, batch), f, indent=2)
    return blob


def load_program(blob: bytes) -> torch.export.ExportedProgram:
    """The exported program of ``export_serving``'s bytes (the custom ops
    are registered by this module's import)."""
    return torch.export.load(io.BytesIO(blob))


def load_serving(blob: bytes):
    """Rehydrate an exported artifact; returns a callable
    ``(tables_w, params, batch, dense_inputs) -> outputs`` that runs under
    ``torch.inference_mode()``, as the predict step does.  The program
    checks its inputs' structure and shapes: a batch of another bucket
    raises."""
    module = load_program(blob).module()

    def call(tables_w, params, batch, dense_inputs=None):
        with torch.inference_mode():
            return module(tables_w, params, batch, dense_inputs)

    return call
