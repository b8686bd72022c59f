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
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Optional

import torch

from .state import TrainState

FILE = "state.pt"


class CheckpointMismatchError(ValueError):
    """A checkpoint's entries differ from the target state's."""


def _as_tree(state: TrainState) -> dict:
    return {"params": state.params, "opt_state": state.opt_state,
            "tables": state.tables, "step": int(state.step)}


def save_checkpoint(path: str, state: TrainState, step: Optional[int] = None) -> str:
    """Write ``state`` as ``<path>/<step>/`` (``step`` defaults to the
    state's), replacing a checkpoint of that step; returns its directory."""
    path = os.path.abspath(path)
    step = int(state.step) if step is None else int(step)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, str(step))
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
    return final


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


def restore_checkpoint(path: str, target: TrainState,
                       step: Optional[int] = None) -> TrainState:
    """The state saved under ``path`` at ``step`` (default: the largest),
    on the device of ``target``'s tensors, after checking it entry by entry
    against ``target``.  ``target`` itself is left as it is."""
    path = os.path.abspath(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    want = _as_tree(target)
    got = torch.load(os.path.join(path, str(step), FILE), weights_only=True,
                     map_location=_device_of(want))
    _check(got, want, "state")
    return TrainState(params=got["params"], opt_state=got["opt_state"],
                      tables=got["tables"], step=got["step"])
