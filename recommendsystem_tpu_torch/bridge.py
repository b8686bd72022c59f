"""Carry weights across from the JAX package, as numpy.

``from_jax_numpy(bundle, params, tables)`` takes what the JAX side hands
over as numpy and imports no JAX:

- ``params``: the flax parameter tree as a nested dict of numpy arrays.
  Flax kernels are ``(in, out)``; the port's layers keep that layout and
  compute ``x @ kernel`` (and ``W.T @ x`` in the transposed InteractingLayer),
  so every array is copied as it is, with no transpose.  The flattened tree
  (keys joined with ".") is the state dict of ``bundle.module``.
- ``tables``: per-storage ``(rows, D)`` numpy weights, as the JAX engine's
  ``weights(state.tables)`` returns them.  JAX autoint tables are stored in
  the packed-state layout (``w_p = [w | 0]`` lane groups); ``weights()``
  unpacks them to ``(rows, D)``, which is the layout the port keeps.

Returns the port's ``TrainState`` on the bundle's device.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .models.base import ModelBundle
from .train.state import TrainState


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def from_jax_numpy(bundle: ModelBundle, params: Mapping[str, Any],
                   tables: Mapping[str, np.ndarray], step: int = 0) -> TrainState:
    flat = _flatten(params)
    want = {k: tuple(p.shape) for k, p in bundle.module.named_parameters()}
    got = {k: tuple(v.shape) for k, v in flat.items()}
    if got != want:
        raise ValueError(f"flax params do not match the port's module: "
                         f"got {sorted(got.items())}, expected "
                         f"{sorted(want.items())}")
    storage = bundle.embedding.storage
    if set(tables) != set(storage):
        raise ValueError(f"tables {sorted(tables)} do not match the engine's "
                         f"storages {sorted(storage)}")
    for skey, w in tables.items():
        if tuple(np.shape(w)) != storage[skey]:
            raise ValueError(f"table {skey}: shape {np.shape(w)}, expected "
                             f"{storage[skey]}")

    def to_dev(a):
        return torch.tensor(np.asarray(a, np.float32), device=bundle.device)

    return TrainState(params={k: to_dev(v) for k, v in flat.items()},
                      opt_state=None,
                      tables={skey: {"w": to_dev(w)} for skey, w in tables.items()},
                      step=step)
