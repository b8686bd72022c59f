"""Checkpoint and resume of the whole train state, in a torch-native format.

Counterpart of ``recommendsystem_tpu/train/checkpoint.py`` (orbax there).
``save_checkpoint(path, state)`` writes ``<path>/<step>/state.pt``: one
``torch.save`` of plain containers (the dense params, the dense Adam state
with its int count, every storage's ``w``, sparse optimizer state and
``show``, and the int step), so that ``torch.load(..., weights_only=True)``
reads it back.  The step's directory is written under a temporary name and
renamed into place, as orbax finalises a step, so a reader never finds half
a checkpoint.

``restore_checkpoint(path, target)`` loads the largest step under ``path``
onto the device of ``target``'s tensors (a checkpoint saved on the card
restores on the CPU and the other way round) and checks every key, shape
and dtype against ``target``, as orbax's abstract restore does:
``CheckpointMismatchError`` names the first entry that differs.

A sharded state checkpoints as whole tensors, as orbax writes a sharded
JAX state's global arrays: ``save_checkpoint(..., mesh=, shardings=)`` is
a collective that gathers the state (``gather_state``: table rows over the
data axis, split columns and experts over the model axis), then rank 0
writes the files a local checkpoint writes, and every rank waits for it.
``restore_checkpoint(..., mesh=, shardings=)`` loads the whole state
memory-mapped (a rank reads its own rows, never every table), checks it
against the whole shapes of the rank's target, and cuts the rank's part
(``shard_state``).  So a sharded checkpoint restores locally, a local one
onto ranks, and either onto any mesh whose shapes fit.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Optional

import torch
import torch.distributed as dist

from .state import TrainState, gather_state, shard_state, state_shardings

FILE = "state.pt"


class CheckpointMismatchError(ValueError):
    """A checkpoint's entries differ from the target state's."""


def _as_tree(state: TrainState) -> dict:
    return {"params": state.params, "opt_state": state.opt_state,
            "tables": state.tables, "step": int(state.step)}


def save_checkpoint(path: str, state: TrainState, step: Optional[int] = None,
                    mesh=None, shardings: Optional[TrainState] = None) -> str:
    """Write ``state`` as ``<path>/<step>/`` (``step`` defaults to the
    state's), replacing a checkpoint of that step; returns its directory.
    With ``mesh`` (a ``core.mesh.Mesh``) ``state`` is this rank's shards,
    placed by ``shardings`` (default: rows split, the rest replicated):
    every rank calls it, the whole state is gathered, rank 0 writes it and
    the others wait until it is in place."""
    path = os.path.abspath(path)
    step = int(state.step) if step is None else int(step)
    final = os.path.join(path, str(step))
    if mesh is not None:
        whole = gather_state(None, state, mesh, shardings)
        if dist.get_rank() == 0:
            _write(path, final, step, whole)
        dist.barrier()
        return final
    _write(path, final, step, state)
    return final


def _write(path: str, final: str, step: int, state: TrainState) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{step}.", suffix=".tmp", dir=path)
    try:
        torch.save(_as_tree(state), os.path.join(tmp, FILE))
        if os.path.exists(final):
            old = tempfile.mkdtemp(prefix=f".{step}.", suffix=".old", dir=path)
            os.replace(final, os.path.join(old, "step"))
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(path: str) -> Optional[int]:
    """The largest numeric step directory under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(d) for d in os.listdir(path) if d.isdigit()]
    return max(steps) if steps else None


def _device_of(tree: Any) -> Optional[torch.device]:
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        for v in tree.values():
            dev = _device_of(v)
            if dev is not None:
                return dev
    return None


def _kind(x: Any) -> str:
    return "tensor" if isinstance(x, torch.Tensor) else type(x).__name__


def _check(got: Any, want: Any, where: str) -> None:
    """Raise ``CheckpointMismatchError`` at the first entry of ``got`` whose
    key, type, shape or dtype differs from ``want``'s."""
    if _kind(got) != _kind(want):
        raise CheckpointMismatchError(f"{where}: {_kind(got)} in the checkpoint, "
                                      f"{_kind(want)} in the target")
    if isinstance(want, dict):
        for k in sorted(set(got) | set(want), key=str):
            if k not in got:
                raise CheckpointMismatchError(f"{where}.{k}: in the target, not in "
                                              f"the checkpoint")
            if k not in want:
                raise CheckpointMismatchError(f"{where}.{k}: in the checkpoint, not in "
                                              f"the target")
            _check(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, torch.Tensor) and (got.shape != want.shape
                                             or got.dtype != want.dtype):
        raise CheckpointMismatchError(
            f"{where}: {tuple(got.shape)} {got.dtype} in the checkpoint, "
            f"{tuple(want.shape)} {want.dtype} in the target")


def _whole(x: Any, placement: Any, mesh) -> Any:
    """A stand-in of the whole tensor of each of a rank's shards ``x``
    (its shape and dtype, no storage), by its placement."""
    if isinstance(x, dict):
        return {k: _whole(v, placement[k], mesh) for k, v in x.items()}
    if not isinstance(x, torch.Tensor):
        return x
    shape = list(x.shape)
    if placement.kind == "row":
        shape[0] *= mesh.size
    elif placement.model_axis:
        shape[placement.dim] *= mesh.model
    return torch.empty(shape, dtype=x.dtype, device="meta")


def restore_checkpoint(path: str, target: TrainState, step: Optional[int] = None,
                       mesh=None, shardings: Optional[TrainState] = None) -> TrainState:
    """The state saved under ``path`` at ``step`` (default: the largest),
    on the device of ``target``'s tensors, after checking it entry by entry
    against ``target``.  ``target`` itself is left as it is.  With
    ``mesh``, ``target`` is this rank's shards placed by ``shardings``
    (default: rows split, the rest replicated): the whole state is read
    memory-mapped, checked against the whole target's shapes, and the
    rank's part cut from it."""
    path = os.path.abspath(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    file = os.path.join(path, str(step), FILE)
    if mesh is not None:
        placements = (state_shardings(None, target, mesh) if shardings is None
                      else shardings)
        want = {"params": _whole(target.params, placements.params, mesh),
                "opt_state": _whole(target.opt_state, placements.opt_state, mesh),
                "tables": _whole(target.tables, placements.tables, mesh),
                "step": int(target.step)}
        got = torch.load(file, weights_only=True, mmap=True, map_location="cpu")
        _check(got, want, "state")
        return shard_state(None, TrainState(params=got["params"], opt_state=got["opt_state"],
                                            tables=got["tables"], step=got["step"]),
                           mesh, placements)
    want = _as_tree(target)
    got = torch.load(file, weights_only=True, map_location=_device_of(want))
    _check(got, want, "state")
    return TrainState(params=got["params"], opt_state=got["opt_state"],
                      tables=got["tables"], step=got["step"])
