"""FLOPs and compulsory bytes of the autoint configuration, from its shapes
and a batch's own ids (whatever implements the step).

FLOPs: the products of the forward (2 m n k each: the four projections
over F fields, the attention's scores and weighted sum, the MLP, the
output unit), three times the forward for a train step.  Bytes: ids and
masks read once; each distinct live row read once; in training each
updated row's w and lazy-Adam state (m, v, t) read and written, and the
dense params with their Adam moments read and written; the outputs
written.  Activations are not counted.
"""

from __future__ import annotations

from harness import peaks
from reference import autoint as model


def flops_per_example(m: dict) -> int:
    f, d = len(m["slots"]), m["dim"]
    cfg = m["interact"]
    u = cfg["unit_num"]
    per_iter = 2 * f * d * u * (4 if cfg["use_res"] else 3) + 2 * 2 * f * f * u
    flops = cfg["layer_num"] * per_iter
    width = f * d
    for unit in m["mlp"]:
        flops += 2 * width * unit
        width = unit
    return flops + 2 * (width + f * u)


def dense_params(m: dict) -> int:
    f, d = len(m["slots"]), m["dim"]
    cfg = m["interact"]
    u = cfg["unit_num"]
    n = (4 if cfg["use_res"] else 3) * (d * u + u) + 2 * u
    width = f * d
    for unit in m["mlp"]:
        n += width * unit + unit
        width = unit
    return n + (width + f * u) + 1


def _live(m, batch, shard=None):
    """{table: (live rows, rows the lazy update scans)}: the whole table,
    or with ``shard`` the rank's block of it (``peaks.table_shard``)."""
    out = {}
    for t, (rows, dim) in model.tables(m).items():
        block = peaks.table_shard(rows, dim, shard)
        parts = [(batch["ids"][k], batch["mask"][k]) for k, tk, _, _ in model.columns(m) if tk == t]
        out[t] = peaks.live_rows(parts, None if shard is None else block), block[1]
    return out


def step(m: dict, entry: str, batch: dict):
    """(FLOPs, bytes) of one step of ``entry`` ("train" or "predict")."""
    b = next(iter(batch["ids"].values())).shape[0]
    d = m["dim"]
    n_ids = sum(v.numel() for v in batch["ids"].values())
    live = {t: n for t, (n, _) in _live(m, batch).items()}
    nbytes = 8 * n_ids + sum(live.values()) * d * 4 + b * 4
    flops = b * flops_per_example(m)
    if entry == "train":
        flops *= 3
        nbytes += sum(live.values()) * 2 * (3 * d * 4 + 4)
        nbytes += dense_params(m) * 3 * 2 * 4
    return flops, nbytes


def kernel(m: dict, name: str, batch: dict, shard=None):
    """(bytes, operations) of one step's call of kernel ``name``, or None
    where this configuration's step has no such kernel.  ``shard`` (rank,
    world): the call of that rank of a sharded step, over the whole
    ``batch`` of every rank (the lazy update of its blocks of the tables'
    storages, ``peaks.table_shard``: each table is a storage of its own,
    as the program's 10 MiB group cap keeps it)."""
    b = next(iter(batch["ids"].values())).shape[0]
    if name == "sparse_update":
        nbytes = ops = 0
        for live, rows in _live(m, batch, shard).values():
            one = peaks.sparse_adam(live, rows, m["dim"])
            nbytes, ops = nbytes + one[0], ops + one[1]
        return nbytes, ops
    if shard is not None:
        return None
    if name == "field_attention_bwd":
        cfg = m["interact"]
        h = cfg["head_num"]
        return peaks.field_attention_bwd(h, cfg["unit_num"] // h, len(m["slots"]), b)
    return None
