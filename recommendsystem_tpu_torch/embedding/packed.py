"""Fused gather-and-fold embedding lookup: the forward half of
``recommendsystem_tpu/embedding/packed.py``.

The JAX package gathers 128-lane physical rows and folds them in Pallas
kernels, a layout the TPU's (8, 128) tiling asks for.  Here tables stay
``(rows, D)`` float32 and contiguous, and the gather is fused into the fold
kernels (``csrc/fold.cu``):

  fold_mean  (K1)  l-major ids/mask of C columns x L slots x B rows ->
                   (C*B, D) masked sums over L
  fold_rows  (K2)  (E,) ids/mask -> (E, D) masked rows; single-id mean
                   columns (l == 1) go here, as in the JAX package

The storage plan (``plan_segments``, ``storage_stream``), the stage functions
(``gather_fold``, ``combine_from_acts``) and ``lookup_packed`` keep the JAX
names and stream order.  The 128-lane pack sizes survive only to size the
engine's storages as the JAX engine does (``gather_pack``, ``scatter_pack``).

Each kernel wrapper takes its plain PyTorch version for a CPU tensor and
launches its kernel for a CUDA tensor; there is no fallback from one to the
other.  The backward half (unfold, scatter, lazy Adam) comes with slice 2.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from ..kernels._build import check, count_launch, library, require, stream_handle

_LANES = 128


def gather_pack(d: int) -> int:
    """Rows per 128-lane physical row in the JAX gather packing."""
    return max(1, _LANES // d)


def scatter_pack(d: int) -> int:
    """Rows per 128-lane physical row in the JAX scatter packing ([grad |
    count] groups of D+1 lanes)."""
    return max(1, _LANES // (d + 1))


def packable(d: int) -> bool:
    """Dims whose [grad | count] group fits one 128-lane row (d <= 127)
    take the fold path, as in the JAX package."""
    return d + 1 <= _LANES


# ---------------------------------------------------------------------------
# K1 / K2: fold kernels and their plain versions
# ---------------------------------------------------------------------------

def fold_mean_plain(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                    c: int, l: int) -> torch.Tensor:
    """(rows, D) table, l-major (C*L*B,) ids and mask -> (C*B, D) sums over
    L of ``mask * table[id]``."""
    d = table.shape[1]
    b = ids.shape[0] // (c * l)
    rows = table[ids.long()] * mask[:, None]
    return rows.reshape(c, l, b, d).sum(1).reshape(c * b, d)


def fold_rows_plain(table: torch.Tensor, ids: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """(rows, D) table, (E,) ids and mask -> (E, D) ``mask * table[id]``."""
    return table[ids.long()] * mask[:, None]


def _check_fold_args(table, ids, mask) -> None:
    require(table, "table", torch.float32)
    if table.ndim != 2:
        raise ValueError(f"table: expected (rows, D), got {tuple(table.shape)}")
    require(ids, "ids", torch.int32, device=table.device)
    if ids.ndim != 1:
        raise ValueError(f"ids: expected (E,), got {tuple(ids.shape)}")
    require(mask, "mask", torch.float32, ids.shape, table.device)
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fold: no kernel for device {table.device}")


def fold_mean(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
              c: int, l: int) -> torch.Tensor:
    """K1: gather + masked sum over the L slots of C mean columns.  ``ids``
    and ``mask`` are l-major per column: slot j of row b of column ci at
    ``(ci*L + j)*B + b``.  Returns (C*B, D) float32."""
    if l == 1:
        # single-id mean columns are per-row folds
        return fold_rows(table, ids, mask)
    _check_fold_args(table, ids, mask)
    e = ids.shape[0]
    if e % (c * l):
        raise ValueError(f"fold_mean: {e} ids do not split into {c} columns "
                         f"of {l} slots")
    if table.device.type == "cpu":
        return fold_mean_plain(table, ids, mask, c, l)
    b, d = e // (c * l), table.shape[1]
    out = torch.empty((c * b, d), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    lib = library("fold")
    with torch.cuda.device(table.device):
        code = lib.fold_mean_f32(table.data_ptr(), ids.data_ptr(),
                                 mask.data_ptr(), out.data_ptr(), c, l, b, d,
                                 stream_handle(table.device))
    check(lib, code, "fold_mean")
    count_launch("fold_mean")
    return out


def fold_rows(table: torch.Tensor, ids: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """K2: gather + per-entry mask.  Returns (E, D) float32."""
    _check_fold_args(table, ids, mask)
    if table.device.type == "cpu":
        return fold_rows_plain(table, ids, mask)
    e, d = ids.shape[0], table.shape[1]
    out = torch.empty((e, d), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    lib = library("fold")
    with torch.cuda.device(table.device):
        code = lib.fold_rows_f32(table.data_ptr(), ids.data_ptr(),
                                 mask.data_ptr(), out.data_ptr(), e, d,
                                 stream_handle(table.device))
    check(lib, code, "fold_rows")
    count_launch("fold_rows")
    return out


# ---------------------------------------------------------------------------
# storage-level plan + stage functions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    """One contiguous slice of a storage's flat id stream.  Mean segments
    are L-MAJOR per column (a column's (B, L) ids transpose to (L, B) before
    flattening); seq segments stay b-major (their (B, T, D) output requires
    it).  Either way each column occupies one contiguous stream block."""
    kind: str                # 'mean' or 'seq'
    keys: Tuple[str, ...]    # member columns (same L for 'mean')
    l: int                   # ids per example
    start: int               # row offset in the storage stream
    size: int                # number of stream rows (= X*l or B*T)


def plan_segments(eng, batch, storages=None) -> Dict[str, List[Segment]]:
    """Group each storage's present columns into fold-sized segments: mean
    columns bucketed by L (one fold_mean call per bucket, columns ordered
    table-major), one seq segment per sequence column.  ``storages``:
    optional set restricting the plan."""
    plans: Dict[str, List[Segment]] = {}
    for skey, keys in eng._per_storage_columns(batch).items():
        if storages is not None and skey not in storages:
            continue
        segs: List[Segment] = []
        by_l: Dict[int, List[str]] = {}
        for key in keys:
            if eng.columns[key].is_sequence:
                continue
            by_l.setdefault(batch[key].rows.shape[1], []).append(key)
        off = 0
        for l, ks in sorted(by_l.items()):
            ks = sorted(ks, key=lambda k: (
                eng.table_map[eng.columns[k].categorical_column.key][1], k))
            size = sum(batch[k].rows.numel() for k in ks)
            segs.append(Segment("mean", tuple(ks), l, off, size))
            off += size
        for key in sorted(k for k in keys if eng.columns[k].is_sequence):
            size = batch[key].rows.numel()
            segs.append(Segment("seq", (key,), batch[key].rows.shape[1],
                                off, size))
            off += size
        plans[skey] = segs
    return plans


def storage_stream(eng, skey: str, segs: List[Segment], batch):
    """Flat (ids int32, mask float32) stream of one storage: columns
    concatenate in segment order; mean columns flatten l-major, seq columns
    b-major."""
    ids_parts, mask_parts = [], []
    for seg in segs:
        for k in seg.keys:
            rows = _offset_rows(eng, k, batch)
            m = batch[k].mask.float()
            if seg.kind == "mean":
                rows, m = rows.t(), m.t()
            ids_parts.append(rows.reshape(-1))
            mask_parts.append(m.reshape(-1))
    return (torch.cat(ids_parts).to(torch.int32).contiguous(),
            torch.cat(mask_parts).contiguous())


def _offset_rows(eng, key: str, batch):
    _, offset, _ = eng.table_map[eng.columns[key].categorical_column.key]
    rows = batch[key].rows
    return rows + offset if offset else rows


def gather_fold(eng, tables, batch, plans) -> Dict[str, Any]:
    """Stage 1: fused gather + fold per segment.  Returns, per storage, the
    folded activations (one array per segment) plus the stream's (ids,
    mask).  ``tables``: the engine state dict ({skey: {"w": (rows, D)}})."""
    out = {}
    for skey, segs in plans.items():
        ids, mask = storage_stream(eng, skey, segs, batch)
        table = tables[skey]["w"]
        acts = []
        for seg in segs:
            i_seg = ids[seg.start:seg.start + seg.size]
            m_seg = mask[seg.start:seg.start + seg.size]
            if seg.kind == "mean":
                acts.append(fold_mean(table, i_seg, m_seg, len(seg.keys), seg.l))
            else:
                acts.append(fold_rows(table, i_seg, m_seg))
        out[skey] = {"acts": acts, "ids": ids, "mask": mask}
    return out


def combine_from_acts(eng, plans, ctx, batch):
    """Stage 2: per-column outputs with the classic combiner semantics."""
    outputs = {}
    for skey, segs in plans.items():
        for seg, act in zip(segs, ctx[skey]["acts"]):
            if seg.kind == "mean":
                x0 = 0
                for k in seg.keys:
                    b = batch[k].rows.shape[0]
                    sums = act[x0:x0 + b]
                    cnt = batch[k].mask.float().sum(dim=1, keepdim=True)
                    col = eng.columns[k]
                    if col.combiner == "sum":
                        outputs[k] = sums
                    elif col.combiner == "sqrtn":
                        outputs[k] = sums / torch.sqrt(torch.clamp(cnt, min=1.0))
                    else:
                        outputs[k] = sums / torch.clamp(cnt, min=1.0)
                    x0 += b
            else:
                (k,) = seg.keys
                b, t = batch[k].rows.shape
                emb = act.reshape(b, t, -1)
                outputs[k] = (emb, batch[k].mask.bool())
    return outputs


def lookup_packed(eng, tables, batch) -> Dict[str, Any]:
    """Forward-only lookup (eval / predict / serving): fused gather + fold
    for the storages ``storages_packed`` admits, the classic gather for the
    rest.  Same outputs as ``EmbeddingFeatures.lookup``.  ``tables``: the
    engine state dict."""
    pk, _ = storages_packed(eng)
    plans = plan_segments(eng, batch, storages=set(pk))
    ctx = gather_fold(eng, tables, batch, plans)
    out = combine_from_acts(eng, plans, ctx, batch)
    classic_batch = {
        k: v for k, v in batch.items()
        if k in eng.columns
        and eng.table_map[eng.columns[k].categorical_column.key][0]
        not in plans}
    if classic_batch:
        out.update(eng.lookup(eng.weights(tables), classic_batch))
    return out


def storages_packed(eng) -> Tuple[List[str], List[str]]:
    """Split storages into (fold path, classic) sets, by the JAX package's
    rule: packable dim and pack-aligned rows and member offsets (the engine
    aligns both)."""
    packed, classic = [], []
    for skey, (rows, d) in eng.storage.items():
        ok = (packable(d)
              and rows % gather_pack(d) == 0
              and all(off % gather_pack(d) == 0 and off % scatter_pack(d) == 0
                      for off, _, _ in eng._storage_members(skey)))
        (packed if ok else classic).append(skey)
    return packed, classic
