"""Model bundle contract of the port.

Counterpart of ``recommendsystem_tpu/models/base.py``.  A factory returns
one ``ModelBundle``: the dense tower (an ``nn.Module`` mapping ``(embs,
training)`` to ``{task: output}``), the embedding engine that feeds it, the
task names and the device.  The tower is the template of the parameters: a
``TrainState`` holds them as a dict and the steps apply the tower with
``torch.func.functional_call``, as flax applies a module to a parameter
tree.  The training fields (losses, metrics, dense optimizer) come with
slice 2 of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..embedding.engine import EmbeddingFeatures


@dataclasses.dataclass
class ModelBundle:
    name: str
    module: nn.Module                            # (embs, training=...) -> Dict[task, out]
    embedding: EmbeddingFeatures
    tasks: Tuple[str, ...]                       # the outputs predict_view serves
    device: torch.device
    # tasks whose outputs differ between train and predict graphs
    predict_outputs: Optional[Dict[str, str]] = None
    # batch column keys the model consumes besides the embedding columns
    dense_input_keys: tuple = ()
    config: Any = None

    def init(self, seed: int):
        """(params, tables) drawn from one ``torch.Generator`` on the
        bundle's device seeded with ``seed``: the tables first (sorted
        storage order), then every submodule's ``reset_parameters`` in
        registration order."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        tables = self.embedding.init(generator)
        for mod in self.module.modules():
            if mod is not self.module and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(generator)
        params = {k: p.detach() for k, p in self.module.named_parameters()}
        return params, tables

    def predict_view(self, outputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Map a full output dict to the online-serving outputs."""
        if not self.predict_outputs:
            return {t: outputs[t] for t in self.tasks}
        return {task: outputs[src] for task, src in self.predict_outputs.items()}


MODEL_REGISTRY: Dict[str, Callable[..., ModelBundle]] = {}


def register_model(name: str):
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        return fn
    return deco


def create_model(name: str, **kwargs) -> ModelBundle:
    """Build a registered model; ``device`` defaults to ``"cuda"`` and
    raises where CUDA is absent (pass ``device="cpu"``)."""
    return MODEL_REGISTRY[name](**kwargs)
