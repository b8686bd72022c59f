"""Train state: dense params + optimizer state + sparse tables + step.

Counterpart of ``recommendsystem_tpu/train/state.py``.  ``params`` is a
dict of tensors named as the bundle's module names its parameters (the
flattened flax tree); ``tables`` is the engine state ({storage_key: {"w":
(rows, D)}}).  ``opt_state`` stays ``None`` until the train step (slice 2).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..models.base import ModelBundle


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    opt_state: Any
    tables: Dict[str, Dict[str, torch.Tensor]]
    step: int = 0


def create_train_state(bundle: ModelBundle, seed: int = 0) -> TrainState:
    """Freshly initialised state on the bundle's device, from ``seed``."""
    params, tables = bundle.init(seed)
    return TrainState(params=params, opt_state=None, tables=tables, step=0)
