"""The process mesh and distributed set-up of the sharded mode.

Counterpart of ``recommendsystem_tpu/core/mesh.py``.  The JAX package runs
one process over an SPMD ``jax.sharding.Mesh``: the batch is split over
``DATA_AXIS``, the embedding tables are row-sharded over the same axis,
and ``shard_map`` bodies exchange rows with ``all_to_all``.  The port runs
one process per rank instead: each rank holds its rows of every table and
its rows of the batch, keeps the dense state whole, and calls the
collectives of ``torch.distributed`` itself (NCCL between cards, gloo
between CPU processes).  ``Mesh`` is that rank's view: its process group,
its rank, the number of ranks on the data axis, and its device.

``create_mesh`` builds the mesh over the initialised process group, or
over a group of one rank that it initialises itself on the port's device
(NCCL on a card): a sharded step always calls the collectives, even
alone.  ``model_parallel=M`` carves the 2-D ``(data, model)`` mesh of the
JAX function: W ranks in the order of its ``reshape(W // M, M)``, rank r
at data index ``r // M`` and model index ``r % M``.  ``Mesh.group``,
``rank`` and ``size`` are then the data axis's (the ranks of one model
index: the exchange, the loss's sums and the dense all-reduce run over
it) and ``model_group``, ``model_rank`` and ``model`` the model axis's
(the ranks of one data index, which hold the same rows of the batch and
of the tables and split the dense kernels or the experts: the
collectives of ``core.model_axis`` run over it).

``data_sharding``, ``replicated``, ``row_sharding``, ``column_sharding``
and ``expert_sharding`` are placement descriptors (``Placement``), the
port's stand-ins for the JAX ``NamedSharding``s:
``train.state.state_shardings`` and ``nn.expert_shardings`` give one for
each leaf of a state, and ``local_part`` cuts a whole tensor to a rank's
part.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Optional, Union

import torch
import torch.distributed as dist

from .device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def process_count() -> int:
    """The number of ranks of the initialised process group, else 1
    (``tn.core.shard_num()``)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank, else 0 (``tn.core.self_shard_id()``)."""
    return dist.get_rank() if dist.is_initialized() else 0


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: Union[str, torch.device] = "cuda",
                     timeout_s: float = 300.0) -> None:
    """Joins the process group of a multi-process run: NCCL when ``device``
    is a card, gloo on the CPU.  ``coordinator`` is ``host:port`` (TCP) or
    an init URL (``tcp://...``, ``file:///path``, as ``torch.distributed``
    takes them); with no coordinator and no ``num_processes`` the
    ``torchrun`` environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``)
    is read.  Does nothing for a single process or where the group is
    already up.  On a card, rank r takes card ``r % device_count``."""
    if dist.is_initialized():
        return
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ.get("RANK", 0)) if process_id is None else process_id
        coordinator = "env://" if coordinator is None else coordinator
    if num_processes is None or num_processes <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError("distributed_init: a multi-process run needs a coordinator "
                         "and this process's id")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(_backend(dev), init_method=url, world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout_s))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the ``(data, model)`` mesh: ``group`` the process
    group of the data axis, ``rank`` this process's index on it, ``size``
    the number of ranks on it, ``device`` where this rank's tensors live;
    ``model_group``, ``model_rank`` and ``model`` the same for the model
    axis (``model_group`` None where ``model`` is 1)."""

    group: object
    rank: int
    size: int
    device: torch.device
    model: int = 1
    axis_names: tuple = (DATA_AXIS, MODEL_AXIS)
    model_group: object = None
    model_rank: int = 0

    @property
    def shape(self):
        return {DATA_AXIS: self.size, MODEL_AXIS: self.model}

    def rows(self, total: int) -> slice:
        """This rank's slice of ``total`` rows split evenly over the data
        axis (``total`` must divide)."""
        if total % self.size:
            raise ValueError(f"{total} rows do not split over {self.size} ranks")
        per = total // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def create_mesh(devices=None, model_parallel: int = 1,
                axis_names: tuple = (DATA_AXIS, MODEL_AXIS)) -> Mesh:
    """The mesh of this process: ``devices`` is this rank's device (None:
    the card, or the CPU where the group is gloo's).  Over the initialised
    process group where there is one; else a group of one rank is
    initialised on ``devices`` (NCCL on a card, gloo on the CPU), so that a
    sharded step on one card runs its exchange through NCCL.  Destroy it
    with ``torch.distributed.destroy_process_group()`` when done.

    ``model_parallel=M`` splits the W ranks into W // M data indices of M
    model ranks each (``ValueError`` where M does not divide W, as the JAX
    function raises).  Every rank creates every subgroup, in one order: the
    M data groups (NCCL on a card, since the exchange takes an all-to-all;
    gloo on the CPU), then the W // M model groups, on the process group's
    own backend.  A gloo model group over card tensors stages its
    collectives through the host (``core.model_axis``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} devices not divisible by model_parallel={model_parallel}")
    if dist.is_initialized():
        default = "cuda" if dist.get_backend() == "nccl" else "cpu"
        dev = resolve_device(default if devices is None else devices)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = resolve_device("cuda" if devices is None else devices)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device()
                               if dev.index is None else dev.index)
            torch.cuda.set_device(dev)
        dist.init_process_group(_backend(dev), store=dist.HashStore(), rank=0,
                                world_size=1)
    if model_parallel == 1:
        return Mesh(group=dist.group.WORLD, rank=dist.get_rank(),
                    size=dist.get_world_size(), device=dev, axis_names=tuple(axis_names))
    m, r = model_parallel, dist.get_rank()
    n_data = world // m
    data_groups = [dist.new_group([d * m + j for d in range(n_data)], backend=_backend(dev))
                   for j in range(m)]
    model_groups = [dist.new_group([d * m + j for j in range(m)], backend=dist.get_backend())
                    for d in range(n_data)]
    return Mesh(group=data_groups[r % m], rank=r // m, size=n_data, device=dev, model=m,
                axis_names=tuple(axis_names), model_group=model_groups[r // m],
                model_rank=r % m)


def local_mesh(n: Optional[int] = None) -> Mesh:
    """``create_mesh()``; ``n``, where given, must be the number of ranks."""
    mesh = create_mesh()
    if n is not None and n != mesh.size:
        raise ValueError(f"local_mesh({n}): the process group has {mesh.size} ranks")
    return mesh


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor lives on the mesh: ``"data"`` (leading dim split over
    the data axis: a batch), ``"row"`` (rows split over the data axis: a
    table and its per-row state; whole over the model axis),
    ``"replicated"`` (whole on every rank), ``"column"`` (last dim split
    over the model axis: a tensor-parallel kernel, the JAX ``P(None,
    MODEL_AXIS)``) or ``"expert"`` (leading dim split over the model axis:
    a stack of experts)."""

    kind: str
    mesh: Mesh

    def local_part(self, x: torch.Tensor) -> torch.Tensor:
        """The part of the whole tensor ``x`` that this rank holds."""
        if self.kind == "replicated":
            return x
        if self.kind in ("column", "expert"):
            dim = self.dim
            per = x.shape[dim] // self.mesh.model
            if per * self.mesh.model != x.shape[dim]:
                raise ValueError(f"{self.kind} placement: dim {x.shape[dim]} does not split "
                                 f"over a model axis of {self.mesh.model}")
            return x.narrow(dim, self.mesh.model_rank * per, per)
        return x[self.mesh.rows(x.shape[0])]

    @property
    def dim(self) -> int:
        """The dim a model-axis placement splits: -1 for a column, 0 for an
        expert stack."""
        return -1 if self.kind == "column" else 0

    @property
    def model_axis(self) -> bool:
        return self.kind in ("column", "expert")


def data_sharding(mesh: Mesh) -> Placement:
    """A batch: leading dim split over DATA_AXIS."""
    return Placement("data", mesh)


def replicated(mesh: Mesh) -> Placement:
    return Placement("replicated", mesh)


def row_sharding(mesh: Mesh) -> Placement:
    """An embedding table: rows split over DATA_AXIS."""
    return Placement("row", mesh)


def column_sharding(mesh: Mesh) -> Placement:
    """A tensor-parallel kernel: last dim split over MODEL_AXIS."""
    return Placement("column", mesh)


def expert_sharding(mesh: Mesh) -> Placement:
    """A stack of experts: leading dim split over MODEL_AXIS."""
    return Placement("expert", mesh)


def local_batch(x, mesh: Mesh):
    """This rank's rows of a whole batch: every tensor of a nest of dicts,
    lists, tuples and dataclasses (``IdBatch``) cut on its leading dim
    (``data_sharding``); None and other leaves pass through."""
    if isinstance(x, torch.Tensor):
        return x[mesh.rows(x.shape[0])]
    if isinstance(x, dict):
        return {k: local_batch(v, mesh) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(local_batch(v, mesh) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: local_batch(getattr(x, f.name), mesh)
                                         for f in dataclasses.fields(x)})
    return x
