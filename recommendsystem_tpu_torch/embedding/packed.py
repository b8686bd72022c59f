"""Fused embedding lookup and packed update: the local path of
``recommendsystem_tpu/embedding/packed.py``.

The JAX package gathers 128-lane physical rows and folds them in Pallas
kernels, and scatters 128-lane [grad | count] payloads, layouts the TPU's
(8, 128) tiling asks for.  Here tables and their optimizer state stay
``(rows, D)`` and contiguous, and each kernel fuses the gather or the
scatter it feeds or is fed by.  A table is float32 or bfloat16 (the
engine's ``table_dtype``), Adam's moments float32 or bfloat16
(``SparseAdam.state_dtype``); the arithmetic is float32 everywhere, a bf16
value is widened where it is read and rounded to nearest even where it is
stored, and the folds' outputs, the accumulators, t, show and g2sum are
float32:

  fold_mean  (K1)  l-major ids/mask of C columns x L slots x B rows ->
                   (C*B, D) masked sums over L; ``fold_mean_group`` folds
                   every mean segment of a step in one launch (csrc/fold.cu)
  fold_rows  (K2)  (E,) ids/mask -> (E, D) masked rows; single-id mean
                   columns (l == 1) and sequence columns go here, as in the
                   JAX package; ``fold_rows_group`` folds every such
                   segment of a step in one launch (csrc/fold.cu)
  unfold_mean_scatter (K3)  (B, D) grads of one column's sums, broadcast
                   over its L slots, added with a count of 1 into the
                   storage's accumulator (its two views, gradient sums and
                   counts); ``unfold_mean_scatter_group``
                   takes every mean column of a step in one launch
                                                    (csrc/unfold_scatter.cu)
  unfold_rows_scatter (K4)  the same per entry, for l == 1 and sequence
                   columns; ``unfold_rows_scatter_group`` takes every
                   such column of a step in one launch
  sparse_adam_update_group  (K8)  one lazy-Adam pass over every storage
                   of a step, in one launch: rows with count > 0 step w, m,
                   v, t and add to show; the accumulators are left zero
                                                    (csrc/sparse_adam.cu)
  sparse_adagrad_update_group  (K9)  the same for ``SparseAdaGrad``: rows
                   with count > 0 add mean(G^2) to g2sum, step w and add
                   to show; the accumulators are left zero
                                                    (csrc/sparse_adagrad.cu)

The storage plan (``plan_segments``, ``storage_stream``), the stage functions
(``gather_fold``, ``combine_from_acts``, ``apply_gradients_packed``) and
``lookup_packed`` keep the JAX names and stream order.  The predict step
asks ``lookup_packed`` to defer the sequence columns: each comes as a
``SequenceRows`` handle on the table and its stream, not gathered, and the
DIN pool (K7) gathers the lanes it reads itself.  A storage's
accumulator is one flat float32 tensor of rows*(D+1) words: a (rows, D)
block of gradient sums followed by a (rows,) block of counts
(``accumulator_views``), where the JAX package interleaves [grad | count]
rows; the split keeps each gradient row 16-byte aligned for the card's
vector reductions and lets the lazy-Adam pass read a dead row's count
alone.  So the 128-lane limit of the JAX layout is not the port's: a
storage of D >= 128 takes the fold path too (``storages_packed``).  The
128-lane pack sizes survive only to size the engine's storages as the JAX
engine does (``gather_pack``, ``scatter_pack``).

``row_update_packed_storage`` is the JAX package's touched-rows update
(sort, segment sum, update of the unique rows only), which the step takes
for the ``state_packable`` storages once they hold
``EmbeddingFeatures.row_update_min_rows`` rows; it is plain PyTorch, as the
JAX package's is plain jnp.

Each kernel wrapper takes its plain PyTorch version for a CPU tensor and
launches its kernel for a CUDA tensor; there is no fallback from one to the
other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct
from typing import Any, Dict, List, Tuple

import torch

from ..kernels import _ops
from ..kernels._build import check, count_launch, library, require, stream_handle
from .optimizers import SparseAdaGrad, SparseAdam

_LANES = 128
_I32 = 1 << 31          # the grouped kernels index a member in 32 bits
# what the kernels read and write: tables (w) and Adam's moments
ROW_DTYPES = (torch.float32, torch.bfloat16)


def _is_bf16(t: torch.Tensor) -> int:
    """A member's type word for the launchers: 1 for bfloat16, 0 for
    float32."""
    return int(t.dtype == torch.bfloat16)


def gather_pack(d: int) -> int:
    """Rows per 128-lane physical row in the JAX gather packing."""
    return max(1, _LANES // d)


def scatter_pack(d: int) -> int:
    """Rows per 128-lane physical row in the JAX scatter packing ([grad |
    count] groups of D+1 lanes)."""
    return max(1, _LANES // (d + 1))


def packable(d: int) -> bool:
    """Dims whose [grad | count] group fits one 128-lane row (d <= 127):
    the JAX package packs these alone (the engine's ``stride_of`` aligns
    their storages as it does); the port's fold path takes wider ones too
    (``storages_packed``)."""
    return d + 1 <= _LANES


# ---------------------------------------------------------------------------
# K1 / K2: fold kernels and their plain versions
# ---------------------------------------------------------------------------

def fold_mean_plain(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                    c: int, l: int) -> torch.Tensor:
    """(rows, D) table, l-major (C*L*B,) ids and mask -> (C*B, D) float32
    sums over L of ``mask * table[id]``."""
    d = table.shape[1]
    b = ids.shape[0] // (c * l)
    rows = table[ids.long()].float() * mask[:, None]
    return rows.reshape(c, l, b, d).sum(1).reshape(c * b, d)


def fold_rows_plain(table: torch.Tensor, ids: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """(rows, D) table, (E,) ids and mask -> (E, D) float32 ``mask *
    table[id]``."""
    return table[ids.long()].float() * mask[:, None]


def _check_fold_args(table, ids, mask) -> None:
    require(table, "table", ROW_DTYPES)
    if table.ndim != 2:
        raise ValueError(f"table: expected (rows, D), got {tuple(table.shape)}")
    require(ids, "ids", torch.int32, device=table.device)
    if ids.ndim != 1:
        raise ValueError(f"ids: expected (E,), got {tuple(ids.shape)}")
    require(mask, "mask", torch.float32, ids.shape, table.device)
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fold: no kernel for device {table.device}")


def _launch_groups(lib, fn, what: str, words: List[int], per_member: int,
                   per_launch: int, device) -> None:
    """Launch ``fn`` over the members packed in ``words`` (``per_member``
    64-bit words each), ``per_launch`` members a launch, counting each
    launch as ``what``.  The words travel as one packed byte string: the C
    launcher copies them into the kernel's parameter struct."""
    n = len(words) // per_member
    if n == 0:
        return
    with torch.cuda.device(device):
        stream = stream_handle(device)
        for i in range(0, n, per_launch):
            k = min(per_launch, n - i)
            chunk = words[i * per_member:(i + k) * per_member]
            check(lib, fn(_pack_words(len(chunk)).pack(*chunk), k, stream), what)
            count_launch(what)


@functools.lru_cache(maxsize=None)
def _pack_words(n: int) -> struct.Struct:
    return struct.Struct(f"{n}q")


def _group_device(items, what: str):
    """The one device of a fold group's members (``(table, ids, mask,
    ...)``), each checked as the fold kernels take them."""
    device = items[0][0].device
    for table, ids, mask, *_ in items:
        if table.device != device:
            raise ValueError(f"{what}: members on {device} and {table.device}")
        _check_fold_args(table, ids, mask)
    return device


def fold_mean_group(items) -> List[torch.Tensor]:
    """K1 over a group: ``items`` are ``(table, ids, mask, c, l)``, each as
    ``fold_mean`` takes them (any l >= 1), all on one device; float32 and
    bf16 tables may share a group.  Returns one (C*B, D) float32 tensor per
    item, in order.  On a card one launch takes up to 64 members (a larger
    group is cut into launches of 64); members with no rows launch
    nothing.  The group goes through the custom op
    ``recommendsystem_tpu_torch::fold_mean_group`` (``kernels/_ops.py``):
    the kernel on a card, ``fold_mean_plain`` on the CPU."""
    items = list(items)
    if not items:
        return []
    _group_device(items, "fold_mean_group")
    for _, ids, _, c, l in items:
        if c < 1 or l < 1 or ids.shape[0] % (c * l):
            raise ValueError(f"fold_mean: {ids.shape[0]} ids do not split into {c} "
                             f"columns of {l} slots")
    tables, ids, masks, cs, ls = (list(x) for x in zip(*items))
    return _ops.op("fold_mean_group")(tables, ids, masks, cs, ls)


def fold_mean_launch(items) -> List[torch.Tensor]:
    """K1's launcher, the op's CUDA implementation: ``items`` checked by
    ``fold_mean_group``, all on one card."""
    device = items[0][0].device
    outs = [torch.empty((ids.shape[0] // l, table.shape[1]), dtype=torch.float32,
                        device=device) for table, ids, _, _, l in items]
    words = []
    for (table, ids, mask, c, l), out in zip(items, outs):
        b, d = ids.shape[0] // (c * l), table.shape[1]
        if out.numel() == 0:
            continue
        if c * l * b >= _I32 or c * b * d >= _I32:
            raise ValueError(f"fold_mean: {c} x {l} x {b} ids of D {d} exceed the "
                             f"kernel's 32-bit indices")
        words += (table.data_ptr(), ids.data_ptr(), mask.data_ptr(), out.data_ptr(),
                  c, l, b, d, _is_bf16(table))
    lib = library("fold")
    _launch_groups(lib, lib.fold_mean_group, "fold_mean", words, 9,
                   lib.fold_max_members(), device)
    return outs


def fold_rows_group(items) -> List[torch.Tensor]:
    """K2 over a group: ``items`` are ``(table, ids, mask)``, each as
    ``fold_rows`` takes them, all on one device; the tables may differ in
    D and in type (float32, bf16).  Returns one (E, D) float32 tensor per
    item, in order.  On a card one launch takes up to 64 members (a larger
    group is cut into launches of 64, each counted as one ``fold_rows``
    launch); members with no entries launch nothing.  The group goes
    through the custom op ``recommendsystem_tpu_torch::fold_rows_group``."""
    items = list(items)
    if not items:
        return []
    _group_device(items, "fold_rows_group")
    tables, ids, masks = (list(x) for x in zip(*items))
    return _ops.op("fold_rows_group")(tables, ids, masks)


def fold_rows_launch(items) -> List[torch.Tensor]:
    """K2's launcher, the op's CUDA implementation: ``items`` checked by
    ``fold_rows_group``, all on one card."""
    device = items[0][0].device
    outs = [torch.empty((ids.shape[0], table.shape[1]), dtype=torch.float32,
                        device=device) for table, ids, _ in items]
    words = []
    for (table, ids, mask), out in zip(items, outs):
        e, d = out.shape
        if out.numel() == 0:
            continue
        if e * d >= _I32:
            raise ValueError(f"fold_rows: {e} entries of D {d} exceed the kernel's "
                             f"32-bit indices")
        words += (table.data_ptr(), ids.data_ptr(), mask.data_ptr(), out.data_ptr(), e, d,
                  _is_bf16(table))
    lib = library("fold")
    _launch_groups(lib, lib.fold_rows_group, "fold_rows", words, 7,
                   lib.fold_max_members(), device)
    return outs


def fold_mean(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
              c: int, l: int) -> torch.Tensor:
    """K1: gather + masked sum over the L slots of C mean columns of a
    float32 or bf16 table.  ``ids`` and ``mask`` are l-major per column:
    slot j of row b of column ci at ``(ci*L + j)*B + b``.  Returns (C*B, D)
    float32: ``fold_mean_group`` with one member."""
    if l == 1:
        # single-id mean columns are per-row folds
        return fold_rows(table, ids, mask)
    return fold_mean_group([(table, ids, mask, c, l)])[0]


def fold_rows(table: torch.Tensor, ids: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """K2: gather + per-entry mask of a float32 or bf16 table.  Returns (E,
    D) float32: ``fold_rows_group`` with one member."""
    return fold_rows_group([(table, ids, mask)])[0]


# ---------------------------------------------------------------------------
# K3 / K4: unfold fused with the scatter-add, and their plain versions
# ---------------------------------------------------------------------------

def accumulator_views(acc: torch.Tensor, d: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (rows, D) gradient sums G and (rows, 1) counts N of a flat
    accumulator of rows*(D+1) floats: views, no copy.  The unfold-scatters
    take the two views, which tie the accumulator to its storage's D."""
    if acc.ndim != 1 or acc.shape[0] % (d + 1):
        raise ValueError(f"acc: expected rows*(D+1) floats for D {d}, got "
                         f"{tuple(acc.shape)}")
    rows = acc.shape[0] // (d + 1)
    return acc[:rows * d].view(rows, d), acc[rows * d:].view(rows, 1)


def unfold_rows_scatter_plain(grads, counts, g, ids, mask) -> None:
    """G[ids[e]] += g[e] and N[ids[e]] += 1 for every live entry, in place
    (G, N: ``grads``, ``counts``)."""
    live = (mask > 0).to(g.dtype)[:, None]
    lids = ids.long()
    grads.index_add_(0, lids, g * live)
    counts.index_add_(0, lids, live)


def unfold_mean_scatter_plain(grads, counts, g, ids, mask, l: int) -> None:
    """G[ids[j*B + b]] += g[b] and N[ids[j*B + b]] += 1 for every live
    slot, in place."""
    unfold_rows_scatter_plain(grads, counts, g.repeat(l, 1), ids, mask)


def _check_unfold_args(grads, counts, g, ids, mask, checked=None) -> None:
    """What K3 and K4 take of a member; ``checked``: a set of the (grads,
    counts) views already checked in this group, by id (members of one
    storage share them), to skip checking them again."""
    require(g, "g", torch.float32)
    if g.ndim != 2:
        raise ValueError(f"g: expected (N, D), got {tuple(g.shape)}")
    views = (id(grads), id(counts))
    if checked is None or views not in checked:
        require(grads, "grads", torch.float32, device=g.device)
        if grads.ndim != 2:
            raise ValueError(f"grads: expected (rows, D), got {tuple(grads.shape)}")
        require(counts, "counts", torch.float32, (grads.shape[0], 1), g.device)
        if checked is not None:
            checked.add(views)
    if grads.shape[1] != g.shape[1]:
        raise ValueError(f"grads: expected (rows, {g.shape[1]}) for g of D "
                         f"{g.shape[1]}, got {tuple(grads.shape)}")
    require(ids, "ids", torch.int32, device=g.device)
    if ids.ndim != 1:
        raise ValueError(f"ids: expected (E,), got {tuple(ids.shape)}")
    require(mask, "mask", torch.float32, ids.shape, g.device)
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unfold: no kernel for device {g.device}")


def _unfold_group_device(items, what: str, l_of) -> torch.device:
    """The one device of an unfold group's members, each checked as K3 or
    K4 takes it (``l_of(item)``: the member's L)."""
    device = items[0][2].device
    checked = set()
    for item in items:
        grads, counts, g, ids, mask = item[:5]
        if g.device != device:
            raise ValueError(f"{what}: members on {device} and {g.device}")
        _check_unfold_args(grads, counts, g, ids, mask, checked)
        l = l_of(item)
        if l < 1 or ids.shape[0] != l * g.shape[0]:
            raise ValueError(f"{what}: {ids.shape[0]} ids for {l} slots of "
                             f"{g.shape[0]} rows")
    return device


def _unfold_words(items, l_of, what: str) -> List[int]:
    """The launchers' 8 words a member (grads, counts, g, ids, mask, L, B,
    D); members with no entries are left out."""
    words = []
    for item in items:
        grads, counts, g, ids, mask = item[:5]
        b, d = g.shape
        l = l_of(item)
        if b == 0 or d == 0:
            continue
        if l * b * d >= _I32:
            raise ValueError(f"{what}: {l} x {b} entries of D {d} exceed the "
                             f"kernel's 32-bit indices")
        words += (grads.data_ptr(), counts.data_ptr(), g.data_ptr(), ids.data_ptr(),
                  mask.data_ptr(), l, b, d)
    return words


def unfold_mean_scatter_group(items) -> None:
    """K3 over a group: ``items`` are ``(grads, counts, g, ids, mask, l)``,
    each as ``unfold_mean_scatter`` takes them (any l >= 1), all on one
    device; members may share an accumulator.  In place.  On a card one
    launch takes up to 512 members (every mean column of a train step; a
    larger group is cut into launches of 512, each counted as one
    ``unfold_mean`` launch); members with no entries launch nothing."""
    items = list(items)
    if not items:
        return None
    device = _unfold_group_device(items, "unfold_mean", lambda it: it[5])
    if device.type == "cpu":
        for item in items:
            unfold_mean_scatter_plain(*item)
        return None
    words = _unfold_words(items, lambda it: it[5], "unfold_mean")
    lib = library("unfold_scatter")
    _launch_groups(lib, lib.unfold_mean_group_f32, "unfold_mean", words, 8,
                   lib.unfold_max_members(), device)
    return None


def unfold_rows_scatter_group(items) -> None:
    """K4 over a group: ``items`` are ``(grads, counts, g, ids, mask)``, each
    as ``unfold_rows_scatter`` takes them, all on one device; members may
    share an accumulator and differ in D.  In place.  On a card one launch
    takes up to 512 members (every single-id and sequence column of a
    train step; a larger group is cut into launches of 512, each counted as
    one ``unfold_rows`` launch); members with no entries launch nothing."""
    items = list(items)
    if not items:
        return None
    device = _unfold_group_device(items, "unfold_rows", lambda it: 1)
    if device.type == "cpu":
        for item in items:
            unfold_rows_scatter_plain(*item)
        return None
    words = _unfold_words(items, lambda it: 1, "unfold_rows")
    lib = library("unfold_scatter")
    _launch_groups(lib, lib.unfold_rows_group_f32, "unfold_rows", words, 8,
                   lib.unfold_max_members(), device)
    return None


def unfold_mean_scatter(grads, counts, g, ids, mask, l: int) -> None:
    """K3: add the (B, D) gradient ``g`` of one mean column's sums into a
    storage's accumulator, ``grads`` (rows, D) and ``counts`` (rows, 1)
    (``accumulator_views``), at each live slot's id, with a count of 1 per
    slot; ``ids``/``mask`` are the column's l-major (L*B,) stream.  In
    place: ``unfold_mean_scatter_group`` with one member.  l == 1 goes to
    K4, as in the JAX package."""
    if l == 1:
        return unfold_rows_scatter(grads, counts, g, ids, mask)
    return unfold_mean_scatter_group([(grads, counts, g, ids, mask, l)])


def unfold_rows_scatter(grads, counts, g, ids, mask) -> None:
    """K4: add each live entry's gradient row ``g[e]`` and a count of 1
    into row ``ids[e]`` of ``grads`` and ``counts``.  In place:
    ``unfold_rows_scatter_group`` with one member."""
    return unfold_rows_scatter_group([(grads, counts, g, ids, mask)])


# ---------------------------------------------------------------------------
# K8: one lazy-Adam pass over a group of storages, and its plain version
# ---------------------------------------------------------------------------

def sparse_adam_update_plain(opt, tstate, acc) -> None:
    """``SparseAdam.update`` on the accumulator's gradient sums and counts,
    in float32 from the stored w, written back into ``tstate`` in place (a
    bf16 w, m or v rounds to nearest even as it is stored); ``acc`` is
    cleared."""
    grads, cnt = accumulator_views(acc, tstate["w"].shape[1])
    w, st = opt.update(tstate["w"].float(), grads, tstate["opt"], (cnt > 0).float())
    tstate["show"].add_(cnt)
    tstate["w"].copy_(w)
    for name in ("m", "v", "t"):
        tstate["opt"][name].copy_(st[name])
    acc.zero_()


_F32 = (torch.float32,)


def _check_lazy_args(tstate, acc, device, fields) -> None:
    """What K8 and K9 take of a storage: w (rows, D) float32 or bf16, the
    optimizer's state ``fields`` ((name, wide, dtypes) triples: (rows, D)
    where wide, else (rows, 1), of one of ``dtypes``), show (rows, 1) and a
    flat accumulator of rows*(D+1), float32, all on ``device``; any other
    dtype raises ``TypeError``."""
    w = tstate["w"]
    require(w, "w", ROW_DTYPES, device=device)
    if w.ndim != 2:
        raise ValueError(f"w: expected (rows, D), got {tuple(w.shape)}")
    rows, d = w.shape
    for name, wide, dtypes in fields:
        require(tstate["opt"][name], name, dtypes, (rows, d if wide else 1), device)
    require(tstate["show"], "show", torch.float32, (rows, 1), device)
    require(acc, "acc", torch.float32, (rows * (d + 1),), device)


def _lazy_pass_group(what, lib_name, opt, tstates, accs, fields, plain, kind_of,
                     scalars) -> None:
    """K8 or K9 over a group of storages (see ``sparse_adam_update_group``):
    on the CPU ``plain`` a storage at a time; on a card the launcher
    ``<lib_name>_group`` (pointers w, the ``fields`` of the optimizer's
    state in order, show, acc; rows; D; ``kind_of(tstate)``, the storage's
    types; the count; ``scalars``; the stream), up to
    ``<lib_name>_max_storages()`` storages a launch, each counted as one
    ``what`` launch.  Storages with no rows launch nothing."""
    tstates, accs = list(tstates), list(accs)
    if len(tstates) != len(accs):
        raise ValueError(f"{len(tstates)} storages for {len(accs)} accumulators")
    if not tstates:
        return None
    device = tstates[0]["w"].device
    for tstate, acc in zip(tstates, accs):
        _check_lazy_args(tstate, acc, device, fields)
    if device.type == "cpu":
        for tstate, acc in zip(tstates, accs):
            plain(opt, tstate, acc)
        return None
    if device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {device}")
    lib = library(lib_name)
    max_d = getattr(lib, f"{lib_name}_max_d")()
    live = [(ts, acc) for ts, acc in zip(tstates, accs) if ts["w"].shape[0] > 0]
    for ts, _ in live:
        if ts["w"].shape[1] > max_d:
            raise ValueError(f"{what}: D {ts['w'].shape[1]} > {max_d}")
    per_launch = getattr(lib, f"{lib_name}_max_storages")()
    launch = getattr(lib, f"{lib_name}_group")
    for i in range(0, len(live), per_launch):
        chunk = live[i:i + per_launch]
        n = len(chunk)
        ptrs = [t.data_ptr() for ts, acc in chunk
                for t in (ts["w"], *(ts["opt"][name] for name, _, _ in fields), ts["show"], acc)]
        ptrs = (ctypes.c_ulonglong * len(ptrs))(*ptrs)
        rows = (ctypes.c_longlong * n)(*[ts["w"].shape[0] for ts, _ in chunk])
        dims = (ctypes.c_int * n)(*[ts["w"].shape[1] for ts, _ in chunk])
        kinds = (ctypes.c_int * n)(*[kind_of(ts) for ts, _ in chunk])
        with torch.cuda.device(device):
            code = launch(ctypes.addressof(ptrs), ctypes.addressof(rows),
                          ctypes.addressof(dims), ctypes.addressof(kinds), n, *scalars,
                          stream_handle(device))
        check(lib, code, what)
        count_launch(what)
    return None


def _adam_kind(tstate) -> int:
    """K8's type bits of a storage: 1 for a bf16 w, 2 for bf16 moments; m
    and v must share their type (``TypeError`` otherwise)."""
    m, v = tstate["opt"]["m"], tstate["opt"]["v"]
    if m.dtype != v.dtype:
        raise TypeError(f"sparse_adam_update: m is {m.dtype} and v {v.dtype}; the "
                        f"moments share one type")
    return _is_bf16(tstate["w"]) | 2 * _is_bf16(m)


def sparse_adam_update_group(opt, tstates, accs) -> None:
    """K8: one lazy-Adam pass of ``opt`` (a ``SparseAdam``) over every
    storage of ``tstates`` with its accumulator of ``accs``, on one device.
    In each storage, rows whose count (``accumulator_views``) is > 0 step
    t, m, v and w by ``SparseAdam.update``'s float32 arithmetic and add the
    count to show; the other rows stay bit-identical.  w and the moments
    (one type for both) are float32 or bf16, each storage its own; the step
    is taken from the unrounded moments and only what is stored rounds.
    Updates each ``tstate`` (w, opt m/v/t, show) in place and leaves each
    ``acc`` zero.  On a card one launch takes up to 64 storages, of any D
    up to ``sparse_adam_max_d()`` (the kernel's limits); a larger group is
    cut into launches of 64."""
    for tstate in tstates:
        _adam_kind(tstate)
    return _lazy_pass_group(
        "sparse_adam_update", "sparse_adam", opt, tstates, accs,
        (("m", True, ROW_DTYPES), ("v", True, ROW_DTYPES), ("t", False, _F32)),
        sparse_adam_update_plain, _adam_kind,
        (opt.learning_rate, opt.beta1, 1 - opt.beta1, opt.beta2, 1 - opt.beta2, opt.epsilon))


def sparse_adam_update(opt, tstate, acc) -> None:
    """K8 over one storage: ``sparse_adam_update_group`` with one member."""
    return sparse_adam_update_group(opt, [tstate], [acc])


# ---------------------------------------------------------------------------
# K9: one lazy-AdaGrad pass over a group of storages, and its plain version
# ---------------------------------------------------------------------------

def sparse_adagrad_update_plain(opt, tstate, acc) -> None:
    """``SparseAdaGrad.update`` on the accumulator's gradient sums and
    counts, in float32 from the stored w, written back into ``tstate`` in
    place (a bf16 w rounds to nearest even); ``acc`` is cleared."""
    grads, cnt = accumulator_views(acc, tstate["w"].shape[1])
    w, st = opt.update(tstate["w"].float(), grads, tstate["opt"], (cnt > 0).float())
    tstate["show"].add_(cnt)
    tstate["w"].copy_(w)
    tstate["opt"]["g2sum"].copy_(st["g2sum"])
    acc.zero_()


def sparse_adagrad_update_group(opt, tstates, accs) -> None:
    """K9: one lazy-AdaGrad pass of ``opt`` (a ``SparseAdaGrad``) over every
    storage of ``tstates`` with its accumulator of ``accs``, on one device.
    In each storage, rows whose count (``accumulator_views``) is > 0 add
    mean(G^2) to g2sum, step w by ``SparseAdaGrad.update``'s float32
    arithmetic and add the count to show; the other rows stay
    bit-identical.  w is float32 or bf16, each storage its own; g2sum is
    float32.  Updates each ``tstate`` (w, opt g2sum, show) in place and
    leaves each ``acc`` zero.  On a card one launch takes up to 64
    storages, of any D up to ``sparse_adagrad_max_d()`` (the kernel's
    limits); a larger group is cut into launches of 64."""
    return _lazy_pass_group("sparse_adagrad_update", "sparse_adagrad", opt, tstates, accs,
                            (("g2sum", False, _F32),), sparse_adagrad_update_plain,
                            lambda ts: _is_bf16(ts["w"]), (opt.learning_rate,))


def sparse_adagrad_update(opt, tstate, acc) -> None:
    """K9 over one storage: ``sparse_adagrad_update_group`` with one member."""
    return sparse_adagrad_update_group(opt, [tstate], [acc])


def sparse_update_group(opt, tstates, accs) -> None:
    """The lazy pass of the engine's sparse optimizer over every storage of
    a step: K8 for ``SparseAdam``, K9 for ``SparseAdaGrad``; any other
    optimizer raises ``NotImplementedError``."""
    if isinstance(opt, SparseAdam):
        return sparse_adam_update_group(opt, tstates, accs)
    if isinstance(opt, SparseAdaGrad):
        return sparse_adagrad_update_group(opt, tstates, accs)
    raise NotImplementedError(f"sparse optimizer {type(opt).__name__}: the packed "
                              f"update has a lazy pass for SparseAdam (K8) and "
                              f"SparseAdaGrad (K9) only")


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


@dataclasses.dataclass(frozen=True)
class SequenceRows:
    """A sequence column's rows, not gathered: what ``lookup_packed(...,
    defer_sequences=True)`` gives for it in place of ``(emb (B, T, D),
    mask)``.  ``table`` is its storage's (rows, D) table, ``ids`` (B, T)
    int32 its b-major stream ids (table offset added), ``mask`` (B, T)
    float32; the column's facts are the lanes ``window`` of ``mask * row``,
    as K2 writes them, and ``mask > 0`` marks the live ones.  The DIN pool
    (``nn.DINPool``) takes a handle and gathers the lanes it reads itself
    (K7's ``din_pool_gather``), which has no gradient: only the predict step
    asks for handles, under ``inference_mode``, and the train step, which
    differentiates the rows, never gets one.  ``dtype`` is the type of the
    facts it stands for: float32 as the lookup gives them, or the compute
    dtype that the predict step casts the embedding activations to
    (``train.step.apply_model``; a float32 table's lanes are then rounded
    to bf16 as K7 reads them)."""

    table: torch.Tensor
    ids: torch.Tensor
    mask: torch.Tensor
    window: Tuple[int, int]
    dtype: torch.dtype = torch.float32

    def lanes(self, start: int, stop: int) -> "SequenceRows":
        """The lanes [start, stop) of this window: ``emb[:, :, start:stop]``
        of the rows it stands for."""
        lo, hi = self.window
        if not 0 <= start < stop <= hi - lo:
            raise ValueError(f"lanes [{start}, {stop}) outside a window of {hi - lo}")
        return dataclasses.replace(self, window=(lo + start, lo + stop))


def gather_fold(eng, tables, batch, plans, defer_sequences: bool = False) -> Dict[str, Any]:
    """Stage 1: fused gather + fold.  Every storage's stream is built
    first; then one grouped K1 folds the mean segments (l > 1) of all the
    storages, and one grouped K2 every single-id or sequence segment.
    Returns, per storage, the folded activations (one tensor per segment)
    plus the stream's (ids, mask).  With ``defer_sequences`` a sequence
    segment is not gathered: its activation is a ``SequenceRows`` handle.
    ``tables``: the engine state dict ({skey: {"w": (rows, D)}})."""
    out, means, rows = {}, [], []
    for skey, segs in plans.items():
        ids, mask = storage_stream(eng, skey, segs, batch)
        table = tables[skey]["w"]
        acts = [None] * len(segs)
        for i, seg in enumerate(segs):
            part = slice(seg.start, seg.start + seg.size)
            member = (table, ids[part], mask[part])
            if seg.kind == "mean" and seg.l > 1:
                means.append((acts, i, member + (len(seg.keys), seg.l)))
            elif seg.kind == "seq" and defer_sequences:
                shape = (seg.size // seg.l, seg.l)
                acts[i] = SequenceRows(table, ids[part].view(shape), mask[part].view(shape),
                                       (0, table.shape[1]))
            else:
                rows.append((acts, i, member))
        out[skey] = {"acts": acts, "ids": ids, "mask": mask}
    for group, fold in ((means, fold_mean_group), (rows, fold_rows_group)):
        for (acts, i, _), act in zip(group, fold([member for _, _, member in group])):
            acts[i] = act
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
            elif isinstance(act, SequenceRows):
                (k,) = seg.keys
                outputs[k] = act
            else:
                (k,) = seg.keys
                b, t = batch[k].rows.shape
                emb = act.reshape(b, t, -1)
                outputs[k] = (emb, batch[k].mask.bool())
    return outputs


def apply_gradients_packed(eng, state, g_acts, plans, ctx, batch):
    """Stage 3 (not differentiated): unfold every column's activation
    grads into its storage's [grad | count] accumulator, then one lazy pass
    of the engine's sparse optimizer over all the storages at once
    (``sparse_update_group``: K8 for Adam, K9 for AdaGrad).  The mean
    columns with l > 1 of every storage go to one grouped K3 (one member a
    column: each column is one contiguous block of the stream); the
    single-id columns and the sequence columns of every storage to one
    grouped K4.

    Where the ``state_packable`` storages of ``plans`` hold at least
    ``eng.row_update_min_rows`` rows together (the JAX package's crossover;
    off by default), those storages take the touched-rows update instead
    (``row_update_packed_storage``: no accumulator, no lazy pass).

    Updates the tables of ``state`` in place (w, the optimizer's state,
    show; the JAX package donates them instead) and returns ``state``.
    ``g_acts``: per storage, the gradients of ``ctx[skey]["acts"]``."""
    packable_state = [skey for skey in plans if state_packable(eng, skey)]
    rows_mode = (sum(eng.storage[skey][0] for skey in packable_state)
                 >= getattr(eng, "row_update_min_rows", 1 << 62))
    accs, means, rows = {}, [], []
    for skey, segs in plans.items():
        d = eng.storage[skey][1]
        ids, mask = ctx[skey]["ids"], ctx[skey]["mask"]
        if rows_mode and skey in packable_state:
            stream_ids, pays = [], []
            for seg, g in zip(segs, g_acts[skey]):
                part = slice(seg.start, seg.start + seg.size)
                if seg.kind == "mean":
                    c = len(seg.keys)
                    # l-major: slot j of row b takes the gradient of row b
                    g = g.reshape(c, 1, -1, d).expand(c, seg.l, -1, d)
                stream_ids.append(ids[part])
                pays.append(_payload(g.reshape(seg.size, d), mask[part]))
            row_update_packed_storage(eng.sparse_opt, state[skey], torch.cat(stream_ids),
                                      torch.cat(pays))
            continue
        accs[skey] = eng.accumulator(skey, ids.device)
        views = accumulator_views(accs[skey], d)
        for seg, g in zip(segs, g_acts[skey]):
            g = g.contiguous()
            if seg.kind == "mean":
                c = len(seg.keys)
                b = seg.size // (c * seg.l)
                for ci in range(c):
                    part = slice(seg.start + ci * seg.l * b, seg.start + (ci + 1) * seg.l * b)
                    member = views + (g[ci * b:(ci + 1) * b], ids[part], mask[part])
                    if seg.l > 1:
                        means.append(member + (seg.l,))
                    else:
                        rows.append(member)
            else:
                part = slice(seg.start, seg.start + seg.size)
                rows.append(views + (g.reshape(seg.size, d), ids[part], mask[part]))
    unfold_mean_scatter_group(means)
    unfold_rows_scatter_group(rows)
    sparse_update_group(eng.sparse_opt, [state[k] for k in accs], list(accs.values()))
    return state


def _payload(g: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(E, D+1) [grad | count] rows of a stream: each live entry's gradient
    and a count of 1, zeros where the mask is 0."""
    live = (mask > 0).to(g.dtype)[:, None]
    return torch.cat([g * live, live], dim=1)


def row_update_packed_storage(opt, tstate, ids: torch.Tensor, pay: torch.Tensor) -> None:
    """The touched-rows update of one storage (JAX
    ``packed.py::row_update_packed_storage``): ``ids`` (E,) the storage
    rows of a step's stream, ``pay`` (E, D+1) their [grad | count] payload
    rows.  Sorts the stream by row, sums each row's payloads, and runs
    ``opt.update_rows`` in float32 on the unique rows whose count is > 0:
    only those rows of w, m, v and t are written (each stored in its own
    type) and their counts added to show; every other row stays
    bit-identical.  In place; plain PyTorch on either device."""
    d = tstate["w"].shape[1]
    if pay.shape != (ids.shape[0], d + 1):
        raise ValueError(f"row update: payload {tuple(pay.shape)} for {ids.shape[0]} ids "
                         f"of D {d}")
    order = torch.argsort(ids, stable=True)
    uniq, seg = torch.unique_consecutive(ids[order], return_inverse=True)
    acc = torch.zeros((uniq.shape[0], d + 1), dtype=torch.float32, device=pay.device)
    acc.index_add_(0, seg, pay[order].float())
    live = acc[:, d] > 0
    rows = uniq[live].long()
    grad, cnt = acc[live, :d], acc[live, d:]
    w = tstate["w"]
    opt_rows = {name: t[rows] for name, t in tstate["opt"].items()}
    w_new, opt_new = opt.update_rows(w[rows].float(), grad, opt_rows, torch.ones_like(cnt))
    w.index_copy_(0, rows, w_new.to(w.dtype))
    for name, t in tstate["opt"].items():
        t.index_copy_(0, rows, opt_new[name].to(t.dtype))
    tstate["show"].index_copy_(0, rows, tstate["show"][rows] + cnt)


# ---------------------------------------------------------------------------
# sharded mode: the fold kernels over the rows received from their owners
# ---------------------------------------------------------------------------
#
# The JAX package exchanges 128-lane physical rows (id // P) and folds them
# with its K1/K2 (``packed.py:750-912``).  The port exchanges logical (D,)
# rows: each storage's stream is routed to the owners of its rows
# (``engine.exchange_plans``: the requests of every storage in one
# all-to-all), one grouped K2 gathers on each owner the rows asked of it
# (float32, a bf16 table's rows widened exactly), and a second all-to-all
# brings every storage's rows back as (n cap, D) buffers.  K1 and K2 then
# fold each buffer as the member's table, with each entry's slot in it as
# its id.  The push runs the other way: K3 (mean columns) and K4
# (single-id and sequence columns) scatter each entry's gradient and a
# count of 1 into its slot of an (n cap)*(D+1) send buffer, one
# all-to-all takes every storage's [grad | count] rows to their owners,
# one grouped K4 adds them into the owners' accumulators at the rows the
# pull asked for, and K8 or K9 runs the lazy pass over each rank's row
# shards: three all-to-alls a step, whatever the number of storages.


def gather_fold_sharded(eng, tables, batch, plans, mesh,
                        defer_sequences: bool = False) -> Dict[str, Any]:
    """Stage 1 of the sharded packed path (not differentiated), with this
    rank's row shards ``tables`` and rows of ``batch``: every storage's
    stream pulls its rows from their owners (two all-to-alls for all the
    storages, one grouped K2 on the owners' side between them), then one
    grouped K1 folds every mean segment and one grouped K2 every single-id
    or sequence segment over the received buffers.  Returns what
    ``gather_fold`` returns, each storage's exchange plan beside its
    stream (``"plan"``).  With ``defer_sequences`` a sequence segment of
    an exchange that drops nothing is a ``SequenceRows`` handle on the
    received buffer (its ids the entries' slots), for K7 to gather."""
    from .engine import a2a_many, exchange_plans
    streams = {skey: storage_stream(eng, skey, segs, batch) for skey, segs in plans.items()}
    xplans = dict(zip(streams, exchange_plans(
        [(ids, tables[skey]["w"].shape[0], mask) for skey, (ids, mask) in streams.items()],
        mesh, eng.a2a_capacity_factor)))
    asked = fold_rows_group([(tables[skey]["w"], p.recv_rows,
                              torch.ones(p.recv_rows.shape, device=p.recv_rows.device))
                             for skey, p in xplans.items()])
    received = dict(zip(xplans, a2a_many(asked, mesh))) if asked else {}
    out, means, rows = {}, [], []
    for skey, segs in plans.items():
        (ids, mask), plan, recv = streams[skey], xplans[skey], received[skey]
        pos, live = plan.positions(), plan.live(mask)
        acts = [None] * len(segs)
        for i, seg in enumerate(segs):
            part = slice(seg.start, seg.start + seg.size)
            member = (recv, pos[part], live[part])
            if seg.kind == "mean" and seg.l > 1:
                means.append((acts, i, member + (len(seg.keys), seg.l)))
            elif seg.kind == "seq" and defer_sequences and plan.keep is None:
                shape = (seg.size // seg.l, seg.l)
                acts[i] = SequenceRows(recv, pos[part].view(shape), mask[part].view(shape),
                                       (0, recv.shape[1]))
            else:
                rows.append((acts, i, member))
        out[skey] = {"acts": acts, "ids": ids, "mask": mask, "plan": plan}
    for group, fold in ((means, fold_mean_group), (rows, fold_rows_group)):
        for (acts, i, _), act in zip(group, fold([member for _, _, member in group])):
            acts[i] = act
    return out


def apply_gradients_packed_sharded(eng, state, g_acts, plans, ctx, batch, mesh):
    """Stage 3 of the sharded packed path (not differentiated): one grouped
    K3 (mean columns with l > 1) and one grouped K4 (the others) scatter
    every entry's gradient and a count of 1 into its slot of its storage's
    send buffer; one all-to-all takes every storage's to the owners; one
    grouped K4 adds what each rank received into its accumulators at the
    rows the pull asked for; then one lazy pass (``sparse_update_group``:
    K8 or K9) over this rank's row shards.  Updates ``state`` (this rank's
    shards) in place and returns it.  ``ctx``: ``gather_fold_sharded``'s."""
    from .engine import a2a_many
    sends, means, rows = {}, [], []
    for skey, segs in plans.items():
        d = eng.storage[skey][1]
        plan = ctx[skey]["plan"]
        pos, live = plan.positions(), plan.live(ctx[skey]["mask"])
        sends[skey] = torch.zeros(plan.recv_rows.shape[0] * (d + 1), dtype=torch.float32,
                                  device=pos.device)
        views = accumulator_views(sends[skey], d)
        for seg, g in zip(segs, g_acts[skey]):
            g = g.contiguous()
            if seg.kind == "mean":
                c = len(seg.keys)
                b = seg.size // (c * seg.l)
                for ci in range(c):
                    part = slice(seg.start + ci * seg.l * b, seg.start + (ci + 1) * seg.l * b)
                    member = views + (g[ci * b:(ci + 1) * b], pos[part], live[part])
                    if seg.l > 1:
                        means.append(member + (seg.l,))
                    else:
                        rows.append(member)
            else:
                part = slice(seg.start, seg.start + seg.size)
                rows.append(views + (g.reshape(seg.size, d), pos[part], live[part]))
    unfold_mean_scatter_group(means)
    unfold_rows_scatter_group(rows)
    views = [accumulator_views(send, eng.storage[skey][1]) for skey, send in sends.items()]
    got = a2a_many([v for pair in views for v in pair], mesh) if views else []
    accs, owned = {}, []
    for i, skey in enumerate(sends):
        local = state[skey]["w"]
        accs[skey] = eng.accumulator(skey, local.device, local.shape[0])
        owned.append(accumulator_views(accs[skey], eng.storage[skey][1])
                     + (got[2 * i], ctx[skey]["plan"].recv_rows, got[2 * i + 1].view(-1)))
    unfold_rows_scatter_group(owned)
    sparse_update_group(eng.sparse_opt, [state[k] for k in accs], list(accs.values()))
    return state


def lookup_packed_sharded(eng, tables, batch, mesh,
                          defer_sequences: bool = False) -> Dict[str, Any]:
    """``lookup_packed`` in sharded mode: the fused lookup over the rows
    pulled from their owners (``gather_fold_sharded``), the classic
    sharded lookup for the storages that cannot pack."""
    pk, _ = storages_packed(eng)
    plans = plan_segments(eng, batch, storages=set(pk))
    ctx = gather_fold_sharded(eng, tables, batch, plans, mesh, defer_sequences)
    out = combine_from_acts(eng, plans, ctx, batch)
    classic_batch = classic_columns(eng, batch, plans)
    if classic_batch:
        out.update(eng.lookup(eng.weights(tables), classic_batch, "sharded", mesh))
    return out


def lookup_packed(eng, tables, batch, defer_sequences: bool = False) -> Dict[str, Any]:
    """Forward-only lookup (eval / predict / serving): fused gather + fold
    for the storages ``storages_packed`` admits, the classic gather for the
    rest.  Same outputs as ``EmbeddingFeatures.lookup``; with
    ``defer_sequences`` the packed sequence columns come as ``SequenceRows``
    handles instead of ``(emb, mask)``.  ``tables``: the engine state
    dict."""
    pk, _ = storages_packed(eng)
    plans = plan_segments(eng, batch, storages=set(pk))
    ctx = gather_fold(eng, tables, batch, plans, defer_sequences)
    out = combine_from_acts(eng, plans, ctx, batch)
    classic_batch = classic_columns(eng, batch, plans)
    if classic_batch:
        out.update(eng.lookup(eng.weights(tables), classic_batch))
    return out


def classic_columns(eng, batch, plans):
    """The engine's columns of ``batch`` whose storage ``plans`` leaves out:
    the columns that take the classic gather."""
    return {k: v for k, v in batch.items()
            if k in eng.columns
            and eng.table_map[eng.columns[k].categorical_column.key][0] not in plans}


def storages_packed(eng) -> Tuple[List[str], List[str]]:
    """Split storages into (fold path, classic) sets.  A float32 or bf16
    storage takes the fold path where its rows and member offsets are
    aligned to the JAX package's packings (an engine built with
    ``packed=True`` aligns both): for a packable D (<= 127), the JAX
    package's rule.  A wider storage, which the JAX package sends to the
    classic path because its [grad | count] row would not fit one
    128-lane row, takes the fold path wherever the engine is built
    packed: the port keeps its rows (rows, D) and its accumulator split
    (``accumulator_views``), and its kernels take any D.  An engine built
    with ``packed=False`` packs no wide storage."""
    packed, classic = [], []
    for skey, (rows, d) in eng.storage.items():
        ok = ((packable(d) or eng.packed)
              and eng.storage_dtype(d) in ROW_DTYPES
              and rows % gather_pack(d) == 0
              and all(off % gather_pack(d) == 0 and off % scatter_pack(d) == 0
                      for off, _, _ in eng._storage_members(skey)))
        (packed if ok else classic).append(skey)
    return packed, classic


def state_packable(eng, skey: str) -> bool:
    """The JAX package's rule for a storage whose optimizer state it packs
    (``packed.py::state_packable``): ``SparseAdam`` with float32 moments, a
    float32 or bf16 table, a packable D, and rows and member offsets
    aligned to the scatter packing.  The port keeps every storage in the
    classic (rows, D) layout; the rule selects the storages that take the
    touched-rows update (``apply_gradients_packed``)."""
    rows, d = eng.storage[skey]
    ps = scatter_pack(d)
    return (isinstance(eng.sparse_opt, SparseAdam)
            and eng.sparse_opt.state_dtype == torch.float32
            and eng.storage_dtype(d) in ROW_DTYPES
            and packable(d)
            and rows % ps == 0
            and all(off % ps == 0 for off, _, _ in eng._storage_members(skey)))
