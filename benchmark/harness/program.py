"""Everything the benchmark takes from the program under test
(``recommendsystem_tpu_torch``): its bundle, its harness entries
(``train.harness.fit`` and ``train.harness.predict``) and its mesh.
Imports of the program happen inside the functions, so the rest of the
benchmark (the reference above all) can be imported without it, and a
test can put a tiny bundle in place of ``build_bundle``.
"""

from __future__ import annotations

from typing import Iterator

import torch

from .traffic import mix


def build_bundle(cfg: dict, device, num_shards: int = 1):
    """The program's bundle of the configuration: its registered factory
    with the configuration's arguments."""
    from recommendsystem_tpu_torch.models.base import create_model

    kwargs = dict(cfg["factory_kwargs"])
    if num_shards > 1:
        kwargs["num_shards"] = num_shards
    return create_model(cfg["factory"], device=device, **kwargs)


def port_item(batch: dict):
    """A benchmark batch as the program's dataset item: (batch of
    IdBatches, dense inputs, labels, sample weight); the dense inputs are
    the batch's dense features ({key: (B, width)}), or None for a
    configuration that has none."""
    from recommendsystem_tpu_torch.embedding.engine import IdBatch

    ids = {k: IdBatch(rows=v, mask=batch["mask"][k]) for k, v in batch["ids"].items()}
    return ids, batch.get("dense"), batch["labels"], batch["weight"]


def seed_stream(seed: int) -> Iterator[int]:
    """The dropout seeds ``fit(..., seed=seed, state=...)`` gives its steps,
    in order: ints below 2**32 drawn from a CPU ``torch.Generator`` seeded
    with ``seed`` (``train/harness.py::seed_stream``)."""
    gen = torch.Generator().manual_seed(seed)
    while True:
        yield int(torch.randint(0, 2 ** 32, (), generator=gen))


def fit_seed(seed: int, phase: int) -> int:
    """The ``fit`` seed of one phase of a run (check steps, warm-up,
    window, trace)."""
    return mix(seed, 0x666974, phase)


def fit(bundle, items, steps, state, seed: int, callbacks=(), mesh=None):
    from recommendsystem_tpu_torch.train.harness import fit as _fit

    kwargs = {"mode": "sharded", "mesh": mesh} if mesh is not None else {}
    return _fit(bundle, items, steps=steps, state=state, seed=seed, log_every=0,
                callbacks=callbacks, **kwargs)


def predict(bundle, items, state):
    from recommendsystem_tpu_torch.train.harness import predict as _predict

    return _predict(bundle, items, state)


def shard_state(bundle, state, mesh):
    from recommendsystem_tpu_torch.train.state import shard_state as _shard

    return _shard(bundle, state, mesh)


def gather_state(bundle, state, mesh):
    from recommendsystem_tpu_torch.train.state import gather_state as _gather

    return _gather(bundle, state, mesh)


def mesh_up(rank: int, world: int, port: int, device):
    """Join the ``world``-rank group at ``localhost:port`` and return this
    rank's mesh (one card a rank)."""
    from recommendsystem_tpu_torch.core.mesh import create_mesh, distributed_init

    distributed_init(f"localhost:{port}", world, rank, device=device)
    return create_mesh()


def drop_report(bundle, batch, mesh):
    """The exchange's dropped entries for this rank's rows of ``batch``, summed over
    the ranks (a collective)."""
    return bundle.embedding.a2a_drop_report(port_item(batch)[0], mesh)
