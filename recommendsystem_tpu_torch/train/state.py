"""Train state: dense params + optimizer state + sparse tables + step.

Counterpart of ``recommendsystem_tpu/train/state.py``.  ``params`` is a
dict of tensors named as the bundle's module names its parameters (the
flattened flax tree); ``opt_state`` is the dense optimizer's state in
optax's shape (``{"count", "mu", "nu"}``, ``train/adam.py``); ``tables`` is
the engine state ({storage_key: {"w", "opt": {"m", "v", "t"}, "show"}}).

In the sharded mode a rank holds its rows of every table and the dense
state, whole or, on a 2-D mesh, its shards of the split leaves:
``state_shardings`` gives each leaf's placement (the JAX function: with
``tensor_parallel`` the large 2-D params' columns split over the model
axis), ``nn.expert_shardings`` a stack's experts split over it, and
``merge_shardings`` puts the two together.  ``shard_state`` cuts a whole
state (for example one carried across from the JAX package) into a rank's
shards, and ``gather_state`` gathers the shards back into the whole
classic view on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict, Optional

import torch
import torch.distributed as dist

from ..core.mesh import Mesh, Placement, column_sharding, replicated, row_sharding
from ..core.model_axis import all_gather

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


def _tree(x, leaf):
    if isinstance(x, dict):
        return {k: _tree(v, leaf) for k, v in x.items()}
    return leaf(x)


def state_shardings(bundle: "ModelBundle", state: TrainState, mesh: Mesh,
                    tensor_parallel: bool = False, tp_min_dim: int = 64) -> TrainState:
    """The placement of every leaf of ``state``
    (``recommendsystem_tpu/train/state.py:40-79``): every table leaf of two
    dims (w, the optimizer's per-row state, show) row-sharded over the data
    axis and whole over the model axis; the dense params, their Adam state
    and the step replicated.  ``tensor_parallel`` puts a ``"column"``
    placement (the JAX ``P(None, MODEL_AXIS)``) on every 2-D param whose
    last dim is at least ``tp_min_dim`` and divides by the model axis, and
    on its Adam ``mu`` and ``nu``, leaf by leaf as the JAX rule does (a
    stacked bias (E, out) among them); at a model axis of 1 nothing
    splits."""
    repl, row, col = replicated(mesh), row_sharding(mesh), column_sharding(mesh)

    def param(x):
        if (tensor_parallel and mesh.model > 1 and getattr(x, "ndim", 0) == 2
                and x.shape[-1] >= tp_min_dim and x.shape[-1] % mesh.model == 0):
            return col
        return repl

    return TrainState(
        params=_tree(state.params, param),
        opt_state=_tree(state.opt_state, param),
        tables=_tree(state.tables, lambda x: row if getattr(x, "ndim", 0) == 2 else repl),
        step=repl)


def merge_shardings(shardings: TrainState, params: Dict[str, Placement]) -> TrainState:
    """``shardings`` with every param placement of ``params`` (for example
    ``nn.expert_shardings``'s) that splits its leaf put in place of the
    param's own, and of its Adam ``mu`` and ``nu``'s: the JAX
    ``jax.tree.map`` merge of two sharding trees."""
    split = {k: p for k, p in params.items() if p.kind != "replicated"}

    def put(tree):
        return {k: split.get(k, p) for k, p in tree.items()}

    opt = dict(shardings.opt_state)
    for moment in ("mu", "nu"):
        if isinstance(opt.get(moment), dict):
            opt[moment] = put(opt[moment])
    return dataclasses.replace(shardings, params=put(shardings.params), opt_state=opt)


def shard_state(bundle: "ModelBundle", state: TrainState, mesh: Mesh,
                shardings: Optional[TrainState] = None) -> TrainState:
    """This rank's part of a whole ``state``, placed by ``shardings``
    (default ``state_shardings(bundle, state, mesh)``): copies of the
    replicated leaves, of the rank's rows of every table leaf and of its
    columns or experts of every split param and moment, on the mesh's
    device."""

    def cut(x, placement):
        if isinstance(x, dict):
            return {k: cut(v, placement[k]) for k, v in x.items()}
        if not isinstance(x, torch.Tensor):
            return x
        return placement.local_part(x).to(mesh.device).clone()

    placements = state_shardings(bundle, state, mesh) if shardings is None else shardings
    return TrainState(params=cut(state.params, placements.params),
                      opt_state=cut(state.opt_state, placements.opt_state),
                      tables=cut(state.tables, placements.tables), step=state.step)


def gather_state(bundle: "ModelBundle", state: TrainState, mesh: Mesh,
                 shardings: Optional[TrainState] = None) -> TrainState:
    """The whole state from every rank's shards (``shard_state``'s
    inverse): each table leaf all-gathered over the data axis, each
    ``"column"`` or ``"expert"`` leaf of ``shardings`` over the model axis
    (on its last or its leading dim), every other leaf as this rank holds
    it.  A collective: every rank calls it."""

    def tables(x):
        if isinstance(x, dict):
            return {k: tables(v) for k, v in x.items()}
        if not isinstance(x, torch.Tensor) or x.ndim != 2:
            return x
        return all_gather(x, 0, mesh.group, mesh.size)

    def dense(x, placement):
        if isinstance(x, dict):
            return {k: dense(v, None if placement is None else placement[k])
                    for k, v in x.items()}
        if placement is None or not isinstance(x, torch.Tensor) or not placement.model_axis:
            return x
        return all_gather(x, placement.dim, mesh.model_group, mesh.model)

    sh = shardings
    return TrainState(params=dense(state.params, sh and sh.params),
                      opt_state=dense(state.opt_state, sh and sh.opt_state),
                      tables=tables(state.tables), step=state.step)
