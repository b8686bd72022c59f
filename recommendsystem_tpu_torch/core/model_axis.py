"""The model axis of the 2-D ``(data, model)`` mesh: tensor and expert
parallelism, with the model group's collectives called by hand.

In the JAX package a state placed by ``train.state.state_shardings(
tensor_parallel=True)`` (a dense kernel's columns split over MODEL_AXIS)
or by ``nn.expert_shardings`` (a stack's experts split over it) runs the
same step: XLA (GSPMD) reads the placements and inserts the collectives.
The port runs one process a rank, so the layers that hold a shard call
these functions themselves:

- ``copy_to_model(x)``: x as it is; in the backward, its gradient summed
  over the model group (each rank's columns or experts gave a part of it);
- ``gather_from_model(x, dim)``: the ranks' parts of an activation
  all-gathered along ``dim``; in the backward, the rank's own slice of the
  gradient (every model rank computes the whole loss from the whole
  activation, so each holds the whole gradient);
- ``gather_leaf(x, placement)``: a parameter's whole tensor from its
  shards, for a leaf that no layer reads as a shard (for example a stacked
  bias (E, out) whose columns ``tensor_parallel`` split); in the backward,
  the rank's slice of the gradient;
- ``sum_over_model(x)``: x summed over the model group, its gradient passed
  through as it is (the L1L2 penalty of the kernel shards: each rank's
  term is its own, the value the whole kernel's).

The steps (``train.step``) say which mesh the layers run under with
``use(mesh)``, as they set ``kernels.field_attention.sample_offset``;
``current()`` gives it, None outside a step or where the model axis is 1,
and there each function is the identity.  The functions move data and
nothing else, in any dtype.  A gloo model group over card tensors (two
ranks on one card, where NCCL refuses a second rank on a device) stages
each collective through pinned host tensors, since gloo takes no
all-gather of card tensors.

``sync_replicas`` keeps the model replicas of the tables bit-equal: the
ranks of one data index hold the same row shards and apply the same
sparse update, but on a card the unfold-scatter's atomics (K3, K4) add in
no fixed order, so model index 0's rows are broadcast over the model
group after each update.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, Placement

_current: Optional[Mesh] = None
# what the collectives moved, read by the card's smoke run: the bytes that
# all-gathers gave and all-reduces summed, the host seconds of the
# collectives staged through the host (each one waits for the card), and
# ``sync_replicas``'s calls, bytes broadcast and bytes of the replicas that
# differed from model index 0's
_STATS0 = {"gathered_bytes": 0, "reduced_bytes": 0, "staged_s": 0.0, "sync_calls": 0,
           "sync_bytes": 0, "differed_bytes": 0}
_stats: Dict[str, object] = dict(_STATS0)


@contextlib.contextmanager
def use(mesh: Optional[Mesh]) -> Iterator[None]:
    """The mesh the layers run under within the block (None, or a mesh
    with a model axis of 1: none)."""
    global _current
    prev = _current
    _current = mesh if mesh is not None and mesh.model > 1 else None
    try:
        yield
    finally:
        _current = prev


def current() -> Optional[Mesh]:
    """The mesh set by ``use``, or None."""
    return _current


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _pinned(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)


def _all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A new tensor: x summed over the model group."""
    _stats["reduced_bytes"] += x.numel() * x.element_size()
    if _staged(x, mesh.model_group):
        t0 = time.perf_counter()
        h = _pinned(x)
        dist.all_reduce(h, group=mesh.model_group)
        _stats["staged_s"] += time.perf_counter() - t0
        return h.to(x.device, non_blocking=True)
    out = x.clone()
    dist.all_reduce(out, group=mesh.model_group)
    return out


def all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks of ``group``'s x (one shape) concatenated along
    ``dim``, in rank order; staged through pinned host tensors where
    ``group`` is gloo's and x lies on a card."""
    src = x.contiguous()
    _stats["gathered_bytes"] += n * src.numel() * src.element_size()
    if _staged(x, group):
        t0 = time.perf_counter()
        src = _pinned(src)
        buf = torch.empty((n,) + tuple(src.shape), dtype=src.dtype, pin_memory=True)
        dist.all_gather(list(buf.unbind(0)), src, group=group)
        _stats["staged_s"] += time.perf_counter() - t0
        parts = buf.to(x.device, non_blocking=True).unbind(0)
    else:
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim)


def _slice(g: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    per = g.shape[dim] // mesh.model
    return g.narrow(dim, mesh.model_rank * per, per).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return all_gather(x, dim, mesh.model_group, mesh.model)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.mesh), None, None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    mesh = current() if mesh is None else mesh
    return mesh if mesh is not None and mesh.model > 1 else None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Identity forward; the gradient summed over the model group."""
    mesh = _mesh(mesh)
    return x if mesh is None else _CopyToModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, dim: int, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The model ranks' parts all-gathered along ``dim``; the backward
    takes the rank's slice of the gradient."""
    mesh = _mesh(mesh)
    return x if mesh is None else _GatherFromModel.apply(x, dim, mesh)


def gather_leaf(x: torch.Tensor, placement: Placement) -> torch.Tensor:
    """The whole parameter from this rank's shard ``x`` (a ``"column"`` or
    ``"expert"`` placement); the backward takes the rank's slice."""
    return gather_from_model(x, placement.dim, placement.mesh)


def sum_over_model(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """x summed over the model group; the gradient passes through."""
    mesh = _mesh(mesh)
    return x if mesh is None else _SumOverModel.apply(x, mesh)


def sync_replicas(tables, rows: Optional[Dict[str, torch.Tensor]], mesh: Mesh) -> int:
    """Model index 0's ``rows`` of every table leaf (w, each optimizer
    state, show) broadcast over the model group, in one broadcast, and
    written into the other model ranks' replicas.  ``rows`` is {storage:
    local rows (int64)}; a storage it leaves out (or ``rows`` None) sends
    every row of its shard.  Returns the bytes broadcast (0 where the model
    axis is 1)."""
    if mesh.model == 1:
        return 0
    leaves = []
    for skey, t in tables.items():
        idx = None if rows is None else rows.get(skey)
        for leaf in (t["w"], *t["opt"].values(), t["show"]):
            leaves.append((leaf, idx))
    parts = [(leaf if idx is None else leaf.index_select(0, idx))
             .contiguous().reshape(-1).view(torch.uint8) for leaf, idx in leaves]
    mine = torch.cat(parts)
    root = dist.get_global_rank(mesh.model_group, 0)
    if _staged(mine, mesh.model_group):
        t0 = time.perf_counter()
        h = _pinned(mine)
        dist.broadcast(h, src=root, group=mesh.model_group)
        _stats["staged_s"] += time.perf_counter() - t0
        got = h.to(mine.device, non_blocking=True)
    else:
        got = mine.clone()
        dist.broadcast(got, src=root, group=mesh.model_group)
    _stats["sync_calls"] += 1
    _stats["sync_bytes"] += got.numel()
    if mesh.model_rank != 0:
        _stats["differed_bytes"] = _stats["differed_bytes"] + (got != mine).sum()
        for (leaf, idx), part in zip(leaves, got.split([p.numel() for p in parts])):
            shape = leaf.shape if idx is None else (idx.shape[0],) + tuple(leaf.shape[1:])
            vals = part.view(leaf.dtype).view(shape)
            if idx is None:
                leaf.copy_(vals)
            else:
                leaf.index_copy_(0, idx, vals)
    return got.numel()


def collective_stats() -> Dict[str, float]:
    """This rank's counts since ``reset_collective_stats``: the bytes the
    all-gathers gave and the all-reduces summed, the host seconds of the
    staged collectives, and ``sync_replicas``'s calls, bytes broadcast and
    bytes that differed from model index 0's (a host read)."""
    return {k: float(v) if k == "staged_s" else int(v) for k, v in _stats.items()}


def reset_collective_stats() -> None:
    _stats.update(_STATS0)
