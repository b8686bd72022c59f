"""Train state: dense params + optimizer state + sparse tables + step.

Counterpart of ``recommendsystem_tpu/train/state.py``.  ``params`` is a
dict of tensors named as the bundle's module names its parameters (the
flattened flax tree); ``opt_state`` is the dense optimizer's state in
optax's shape (``{"count", "mu", "nu"}``, ``train/adam.py``); ``tables`` is
the engine state ({storage_key: {"w", "opt": {"m", "v", "t"}, "show"}}).

In the sharded mode a rank holds the dense state whole and its rows of
every table: ``state_shardings`` gives each leaf's placement (the JAX
function, ``tensor_parallel=False``), ``shard_state`` cuts a whole state
(for example one carried across from the JAX package) into a rank's
shards, and ``gather_state`` gathers the shards back into the whole
classic view on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict

import torch
import torch.distributed as dist

from ..core.mesh import ITEM_12B, Mesh, replicated, row_sharding

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


def state_shardings(bundle: "ModelBundle", state: TrainState, mesh: Mesh,
                    tensor_parallel: bool = False, tp_min_dim: int = 64) -> TrainState:
    """The placement of every leaf of ``state``: the dense params, their
    Adam state and the step replicated; every table leaf of two dims (w,
    the optimizer's per-row state, show) row-sharded over the data axis
    (``recommendsystem_tpu/train/state.py:40-79``).  ``tensor_parallel``
    (the model axis) raises ``NotImplementedError``: ROADMAP item 12b."""
    if tensor_parallel:
        raise NotImplementedError(ITEM_12B)
    repl, row = replicated(mesh), row_sharding(mesh)

    def tree(x, leaf):
        if isinstance(x, dict):
            return {k: tree(v, leaf) for k, v in x.items()}
        return leaf(x)

    return TrainState(
        params=tree(state.params, lambda _: repl),
        opt_state=tree(state.opt_state, lambda _: repl),
        tables=tree(state.tables, lambda x: row if getattr(x, "ndim", 0) == 2 else repl),
        step=repl)


def shard_state(bundle: "ModelBundle", state: TrainState, mesh: Mesh) -> TrainState:
    """This rank's part of a whole ``state`` (its placement by
    ``state_shardings``): copies of the dense state and of the rank's rows
    of every table leaf, on the mesh's device."""

    def cut(x, placement):
        if isinstance(x, dict):
            return {k: cut(v, placement[k]) for k, v in x.items()}
        if not isinstance(x, torch.Tensor):
            return x
        return placement.local_part(x).to(mesh.device).clone()

    placements = state_shardings(bundle, state, mesh)
    return TrainState(params=cut(state.params, placements.params),
                      opt_state=cut(state.opt_state, placements.opt_state),
                      tables=cut(state.tables, placements.tables), step=state.step)


def gather_state(bundle: "ModelBundle", state: TrainState, mesh: Mesh) -> TrainState:
    """The whole state from every rank's shards (``shard_state``'s
    inverse): each table leaf all-gathered over the data axis, the dense
    state as this rank holds it.  A collective: every rank calls it."""

    def gather(x):
        if isinstance(x, dict):
            return {k: gather(v) for k, v in x.items()}
        if not isinstance(x, torch.Tensor) or x.ndim != 2:
            return x
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        return torch.cat(parts)

    return TrainState(params=dict(state.params), opt_state=state.opt_state,
                      tables=gather(state.tables), step=state.step)
