"""Model bundle contract of the port.

Counterpart of ``recommendsystem_tpu/models/base.py``.  A factory returns
one ``ModelBundle``: the dense tower (an ``nn.Module`` mapping ``(embs,
training, seed)`` to ``{task: output}``), the embedding engine that feeds it
(with its sparse optimizer), the task names, the losses and their weights,
the dense optimizer, the device, the eval metrics ({task: [Metric]},
``train/metrics.py``, the JAX factories' lists) and the compute dtype of
the dense tower (the JAX package's mixed-precision policy: float32, or
bfloat16, which ``train.step.apply_model`` applies at use).  The tower is the template
of the parameters: a ``TrainState`` holds them as a dict and the steps
apply the tower with ``torch.func.functional_call``, as flax applies a
module to a parameter tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..embedding.engine import EmbeddingFeatures
from ..train.adam import Adam
from ..train.graph import PredictGraphs, TrainGraphs


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
    # task -> loss_fn(y_true, y_pred); per-task weights (default 1.0)
    losses: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    loss_weights: Optional[Dict[str, float]] = None
    dense_optimizer: Adam = dataclasses.field(default_factory=Adam)
    # task -> [Metric] that the eval step updates on the full outputs
    metrics: Dict[str, list] = dataclasses.field(default_factory=dict)
    # the dense tower's compute dtype: float32, or bfloat16 (params, the
    # embedding activations and dense_inputs cast at use, outputs back)
    compute_dtype: torch.dtype = torch.float32
    # the CUDA graphs of the local train step's stage 2, kept across the
    # step functions built for this bundle (``train/graph.py``); a copy
    # made by ``dataclasses.replace`` starts with none
    train_graphs: TrainGraphs = dataclasses.field(default_factory=TrainGraphs, init=False,
                                                  repr=False, compare=False)
    # the CUDA graphs of the local predict step, kept the same way
    predict_graphs: PredictGraphs = dataclasses.field(default_factory=PredictGraphs,
                                                      init=False, repr=False, compare=False)

    def init(self, seed: int):
        """(params, tables) drawn from one ``torch.Generator`` on the
        bundle's device seeded with ``seed``: the tables first (sorted
        storage order), then every submodule's ``reset_parameters`` in
        registration order.  The params are copies: the module's own
        parameters are only the template, so two states of one bundle share
        no tensor (a train step updates its state in place)."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        tables = self.embedding.init(generator)
        for mod in self.module.modules():
            if mod is not self.module and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(generator)
        params = {k: p.detach().clone() for k, p in self.module.named_parameters()}
        return params, tables

    def predict_view(self, outputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Map a full output dict to the online-serving outputs."""
        if not self.predict_outputs:
            return {t: outputs[t] for t in self.tasks}
        return {task: outputs[src] for task, src in self.predict_outputs.items()}


COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def check_compute_dtype(compute_dtype) -> torch.dtype:
    """A factory's ``compute_dtype`` as the bundle's: None and float32 give
    float32 (the tower computes in float32), bfloat16 the JAX package's
    mixed-precision policy (``train.step.apply_model``); any other dtype
    raises ``ValueError`` naming the two it takes."""
    if compute_dtype is None:
        return torch.float32
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype}: expected None, "
                         f"torch.float32 or torch.bfloat16")
    return compute_dtype


def or_float32(dtype):
    """A factory's ``table_dtype`` or ``opt_state_dtype``: None is float32."""
    return torch.float32 if dtype is None else dtype


def table_dtype_kwargs(flag: str) -> dict:
    """A model factory's ``table_dtype`` for the command lines'
    ``--table-dtype`` (fp32, bf16, auto): nothing for fp32, the factories'
    default."""
    if flag == "fp32":
        return {}
    return {"table_dtype": "auto" if flag == "auto" else torch.bfloat16}


def compute_dtype_kwargs(flag: str) -> dict:
    """A model factory's ``compute_dtype`` for the command lines'
    ``--compute-dtype`` (fp32, bf16): nothing for fp32, the default."""
    return {} if flag == "fp32" else {"compute_dtype": torch.bfloat16}


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
