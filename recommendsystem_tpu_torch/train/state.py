"""Train state: dense params + optimizer state + sparse tables + step.

Counterpart of ``recommendsystem_tpu/train/state.py``.  ``params`` is a
dict of tensors named as the bundle's module names its parameters (the
flattened flax tree); ``opt_state`` is the dense optimizer's state in
optax's shape (``{"count", "mu", "nu"}``, ``train/adam.py``); ``tables`` is
the engine state ({storage_key: {"w", "opt": {"m", "v", "t"}, "show"}}).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict

import torch

if TYPE_CHECKING:
    from ..models.base import ModelBundle


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    opt_state: Any
    tables: Dict[str, Dict[str, Any]]
    step: int = 0


def create_train_state(bundle: "ModelBundle", seed: int = 0) -> TrainState:
    """Freshly initialised state on the bundle's device, from ``seed``."""
    params, tables = bundle.init(seed)
    return TrainState(params=params,
                      opt_state=bundle.dense_optimizer.init(params),
                      tables=tables, step=0)
