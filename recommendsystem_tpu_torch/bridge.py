"""Carry state across from the JAX package, as numpy.

``from_jax_numpy(bundle, params, tables, step=0, opt_state=None)`` takes
what the JAX side hands over as numpy and imports no JAX:

- ``params``: the flax parameter tree as a nested dict of numpy arrays.
  Flax kernels are ``(in, out)``; the port's layers keep that layout and
  compute ``x @ kernel`` (and ``W.T @ x`` in the transposed InteractingLayer),
  so every array is copied as it is, with no transpose.  The flattened tree
  (keys joined with ".") is the state dict of ``bundle.module``.
- ``tables``: per storage, either the ``(rows, D)`` weights that the JAX
  engine's ``weights(state.tables)`` returns (the optimizer state then
  starts afresh from ``sparse_opt.init_state``), or the whole per-row state
  that its ``classic_state(state.tables)`` returns: ``{"w": (rows, D),
  "opt": {...}, "show"}``, where ``opt`` holds the sparse optimizer's
  fields (Adam: ``m``, ``v``, ``t``; AdaGrad: ``g2sum``).  JAX autoint
  tables are stored in the packed-state layout (``w_p = [w | 0]``, ``m_p =
  [m | t]``, ``v_p = [v | show]`` lane groups); both views unpack them to
  the per-row layout the port keeps.  Each table array must come in the
  type the port's engine stores it in (``storage_dtype`` for w, the
  optimizer's ``init_state`` types for its fields, float32 for show), else
  a ``ValueError`` names it: the JAX package hands bf16 tables and moments
  over as numpy ``ml_dtypes.bfloat16`` arrays, which widen to float32
  exactly and are stored in bf16 again.
- ``opt_state``: optax's Adam state, as its ``ScaleByAdamState`` (or the
  chain tuple that holds one) with numpy leaves; None starts the dense Adam
  afresh.

Returns the port's ``TrainState`` on the bundle's device.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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


def _adam_fields(opt_state) -> Mapping[str, Any]:
    """{"count", "mu", "nu"} of an optax Adam state, found in a
    ``ScaleByAdamState`` or a chain tuple holding one."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return {"count": opt_state.count, "mu": opt_state.mu, "nu": opt_state.nu}
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            try:
                return _adam_fields(part)
            except ValueError:
                continue
    raise ValueError(f"no Adam state (count, mu, nu) in {type(opt_state).__name__}")


def _check_shapes(what: str, got: Dict[str, tuple], want: Dict[str, tuple]) -> None:
    if got != want:
        raise ValueError(f"{what} do not match the port's module: got "
                         f"{sorted(got.items())}, expected {sorted(want.items())}")


def from_jax_numpy(bundle: ModelBundle, params: Mapping[str, Any],
                   tables: Mapping[str, Any], step: int = 0,
                   opt_state: Optional[Any] = None) -> TrainState:
    flat = _flatten(params)
    want = {k: tuple(p.shape) for k, p in bundle.module.named_parameters()}
    _check_shapes("flax params", {k: v.shape for k, v in flat.items()}, want)
    eng = bundle.embedding
    if set(tables) != set(eng.storage):
        raise ValueError(f"tables {sorted(tables)} do not match the engine's "
                         f"storages {sorted(eng.storage)}")

    def to_dev(a):
        return torch.tensor(np.asarray(a, np.float32), device=bundle.device)

    def table_field(skey, name, a, dtype):
        """A table array on the device in ``dtype``, which must be its own
        type already (bf16 through float32: exact both ways)."""
        got = np.asarray(a).dtype.name
        want = "bfloat16" if dtype == torch.bfloat16 else "float32"
        if got != want:
            raise ValueError(f"table {skey}: {name} is {got}, the engine stores it "
                             f"in {want}")
        return to_dev(a).to(dtype)

    state_tables = {}
    for skey, entry in tables.items():
        rows, dim = eng.storage[skey]
        w = entry["w"] if isinstance(entry, Mapping) else entry
        if tuple(np.shape(w)) != (rows, dim):
            raise ValueError(f"table {skey}: shape {np.shape(w)}, expected "
                             f"{(rows, dim)}")
        w_dtype = eng.storage_dtype(dim)
        if isinstance(entry, Mapping):
            # the optimizer's fields, shapes and types, without allocating them
            meta = eng.sparse_opt.init_state((rows, dim), "meta")
            opt_shapes = {n: tuple(t.shape) for n, t in meta.items()}
            if set(entry["opt"]) != set(opt_shapes):
                raise ValueError(f"table {skey}: optimizer state "
                                 f"{sorted(entry['opt'])}, expected {sorted(opt_shapes)}")
            tstate = {"w": table_field(skey, "w", w, w_dtype),
                      "opt": {n: table_field(skey, n, entry["opt"][n], meta[n].dtype)
                              for n in opt_shapes},
                      "show": table_field(skey, "show", entry["show"], torch.float32)}
            for name, t, shape in ([(n, tstate["opt"][n], shp)
                                    for n, shp in opt_shapes.items()]
                                   + [("show", tstate["show"], (rows, 1))]):
                if tuple(t.shape) != shape:
                    raise ValueError(f"table {skey}: {name} of shape "
                                     f"{tuple(t.shape)}, expected {shape}")
        else:
            tstate = {"w": table_field(skey, "w", w, w_dtype),
                      "opt": eng.sparse_opt.init_state((rows, dim), bundle.device),
                      "show": torch.zeros((rows, 1), device=bundle.device)}
        state_tables[skey] = tstate

    dense = {k: to_dev(v) for k, v in flat.items()}
    if opt_state is None:
        opt = bundle.dense_optimizer.init(dense)
    else:
        fields = _adam_fields(opt_state)
        mu, nu = _flatten(fields["mu"]), _flatten(fields["nu"])
        _check_shapes("Adam mu", {k: v.shape for k, v in mu.items()}, want)
        _check_shapes("Adam nu", {k: v.shape for k, v in nu.items()}, want)
        opt = {"count": int(np.asarray(fields["count"])),
               "mu": {k: to_dev(v) for k, v in mu.items()},
               "nu": {k: to_dev(v) for k, v in nu.items()}}
    return TrainState(params=dense, opt_state=opt, tables=state_tables,
                      step=step)
