"""EmbeddingFeatures: the sparse-embedding engine, local and forward only.

Counterpart of ``recommendsystem_tpu/embedding/engine.py``.  Tables are
grouped into storages exactly as the JAX engine groups them (same storage
keys, member offsets and padded row counts), so weights carry across one to
one (``bridge.py``).  The classic ``lookup`` (gather, then combine) is kept as
the port's own oracle for the fused lookup in ``packed.py``.

Not here yet: the per-row optimizer state and update paths, ``evict`` and
the sharded paths (later slices of the port).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from . import packed as packed_mod
from .feature_column import EmbeddingColumn


@dataclasses.dataclass
class IdBatch:
    """Padded, host-hashed ids of one feature: ``rows`` (B, L) int32 in
    [0, bucket); ``mask`` (B, L) float32 {0, 1}.

    CONTRACT: ``rows`` must already be hashed into [0, bucket_size): the
    fold kernels read ``table[id]`` unchecked.  Every in-package constructor
    hashes with splitmix64 mod bucket; run ``validate_batch`` on batches
    built by hand."""

    rows: torch.Tensor
    mask: torch.Tensor

    @property
    def shape(self):
        return self.rows.shape

    def to(self, device) -> "IdBatch":
        return IdBatch(rows=self.rows.to(device), mask=self.mask.to(device))


def pad_bucket(bucket_size: int, n_shards: int) -> int:
    return ((bucket_size + n_shards - 1) // n_shards) * n_shards


def validate_batch(engine: "EmbeddingFeatures",
                   batch: Dict[str, IdBatch]) -> None:
    """Host-side bounds check of the IdBatch contract: every id must lie in
    [0, bucket).  Reads each column's min and max (a device sync for CUDA
    tensors: run it before moving a batch to the card)."""
    for key, ib in batch.items():
        col = engine.columns.get(key)
        if col is None:
            continue
        bucket = col.categorical_column.bucket_size
        if ib.rows.numel() == 0:
            continue
        lo, hi = int(ib.rows.min()), int(ib.rows.max())
        if lo < 0 or hi >= bucket:
            raise ValueError(
                f"IdBatch[{key}]: ids must be hashed into [0, {bucket}); "
                f"got range [{lo}, {hi}]. Hash raw feasigns with the "
                f"column's category_column (splitmix64 mod bucket) first — "
                f"the lookup reads table rows unchecked.")


def _combine(emb: torch.Tensor, mask: torch.Tensor, combiner: str) -> torch.Tensor:
    """(B, L, D) + (B, L) -> (B, D).  'mean' divides by the live count and
    returns zeros for empty rows (TF embedding_column semantics)."""
    m = mask.to(emb.dtype)
    summed = torch.einsum("bld,bl->bd", emb, m)
    if combiner == "sum":
        return summed
    count = m.sum(dim=1, keepdim=True)
    if combiner == "sqrtn":
        return summed / torch.sqrt(torch.clamp(count, min=1.0))
    return summed / torch.clamp(count, min=1.0)


class EmbeddingFeatures:
    """A collection of embedding columns backed by per-slot tables, grouped
    into storages: ``storage`` maps storage_key -> (total_rows, dim);
    ``table_map`` maps table_key -> (storage_key, row_offset, rows)."""

    def __init__(self, embedding_columns: List[EmbeddingColumn],
                 name: str = "sparse_emb_input", group_tables: bool = False,
                 max_group_bytes: int = 40 << 20):
        self.name = name
        self.group_tables = group_tables
        self.max_group_bytes = max_group_bytes
        self.columns: Dict[str, EmbeddingColumn] = {}
        self.tables: Dict[str, Tuple[int, int]] = {}   # table_key -> (rows, dim)
        for col in embedding_columns:
            key = col.key
            if key in self.columns:
                raise ValueError(f"duplicate embedding column {key}")
            self.columns[key] = col
            tkey = col.categorical_column.key
            rows = pad_bucket(col.categorical_column.bucket_size, 1)
            if tkey in self.tables:
                prev_rows, prev_dim = self.tables[tkey]
                if prev_dim != col.dimension:
                    raise ValueError(f"table {tkey}: inconsistent dims")
                self.tables[tkey] = (max(prev_rows, rows), col.dimension)
            else:
                self.tables[tkey] = (rows, col.dimension)

        self.table_map: Dict[str, Tuple[str, int, int]] = {}
        self.storage: Dict[str, Tuple[int, int]] = {}

        def stride_of(rows: int, dim: int) -> int:
            """Member stride: rows padded to a multiple of both 128-lane
            packings of the JAX engine, so that storages and offsets here
            equal its own (the port itself keeps tables (rows, D))."""
            if not packed_mod.packable(dim):
                return rows
            a = math.lcm(packed_mod.gather_pack(dim),
                         packed_mod.scatter_pack(dim))
            return -(-rows // a) * a

        if group_tables:
            by_shape: Dict[Tuple[int, int], List[str]] = {}
            for tkey in sorted(self.tables):
                by_shape.setdefault(self.tables[tkey], []).append(tkey)
            for (rows, dim), members in sorted(by_shape.items()):
                stride = stride_of(rows, dim)
                per_chunk = len(members)
                if max_group_bytes:
                    bytes_per = stride * dim * 4
                    per_chunk = max(1, min(per_chunk,
                                           max_group_bytes // max(1, bytes_per)))
                chunks = [members[i:i + per_chunk]
                          for i in range(0, len(members), per_chunk)]
                for ci, chunk in enumerate(chunks):
                    if len(chunk) == 1:
                        tkey = chunk[0]
                        self.storage[tkey] = (stride, dim)
                        self.table_map[tkey] = (tkey, 0, stride)
                    else:
                        skey = f"group_{stride}x{dim}" + (
                            f"_c{ci}" if len(chunks) > 1 else "")
                        self.storage[skey] = (stride * len(chunk), dim)
                        for i, tkey in enumerate(chunk):
                            self.table_map[tkey] = (skey, i * stride, stride)
        else:
            for tkey, (rows, dim) in self.tables.items():
                stride = stride_of(rows, dim)
                self.storage[tkey] = (stride, dim)
                self.table_map[tkey] = (tkey, 0, stride)

    # ---------------- state ----------------

    def init(self, generator: torch.Generator) -> Dict[str, Dict[str, torch.Tensor]]:
        """Tables on the generator's device, drawn in sorted storage order:
        truncated normal on [-2, 2] divided by sqrt(D), the TF
        ``embedding_column`` default (``SparseAdam.table_init`` in the JAX
        package).  Only ``w`` exists in this slice."""
        state = {}
        for skey, (rows, dim) in sorted(self.storage.items()):
            w = torch.empty((rows, dim), dtype=torch.float32,
                            device=generator.device)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
            state[skey] = {"w": w.div_(dim ** 0.5)}
        return state

    def weights(self, state) -> Dict[str, torch.Tensor]:
        """(rows, D) weights per storage."""
        return {skey: t["w"] for skey, t in state.items()}

    # ---------------- classic lookup (the port's oracle) ----------------

    def lookup(self, weights: Dict[str, torch.Tensor], batch: Dict[str, IdBatch]):
        """``weights``: {storage_key: (rows, D)}; ``batch``: {column_key:
        IdBatch}.  Mean columns -> (B, D); sequence columns -> ((B, T, D),
        (B, T) bool mask)."""
        return self.combine_raw(self.gather_raw(weights, batch), batch)

    def _per_storage_columns(self, batch) -> Dict[str, List[str]]:
        per_storage: Dict[str, List[str]] = {}
        for key, col in self.columns.items():
            if key in batch:
                skey, _, _ = self.table_map[col.categorical_column.key]
                per_storage.setdefault(skey, []).append(key)
        return per_storage

    def _storage_flat_rows(self, skey: str, keys: List[str], batch):
        """Offset-applied flat row ids of every member column of one
        storage, in member order."""
        flat_ids = []
        for key in keys:
            _, offset, _ = self.table_map[
                self.columns[key].categorical_column.key]
            rows = batch[key].rows
            flat_ids.append((rows + offset if offset else rows).reshape(-1))
        return flat_ids

    def _storage_members(self, skey: str):
        """Member tables of one storage, ordered by row offset."""
        return sorted((off, tkey, rows)
                      for tkey, (sk, off, rows) in self.table_map.items()
                      if sk == skey)

    def gather_raw(self, weights: Dict[str, torch.Tensor],
                   batch: Dict[str, IdBatch]) -> Dict[str, torch.Tensor]:
        """One gather per storage: concat every member column's flat ids,
        index once, split back to (B, L, D)."""
        raw = {}
        for skey, keys in self._per_storage_columns(batch).items():
            flat_ids = self._storage_flat_rows(skey, keys, batch)
            gathered = weights[skey][torch.cat(flat_ids).long()].float()
            start = 0
            for key, ids in zip(keys, flat_ids):
                n = ids.shape[0]
                b, l = batch[key].rows.shape
                raw[key] = gathered[start:start + n].reshape(b, l, -1)
                start += n
        return raw

    def combine_raw(self, raw: Dict[str, torch.Tensor],
                    batch: Dict[str, IdBatch]):
        out = {}
        for key, col in self.columns.items():
            if key not in raw:
                continue
            ids = batch[key]
            if col.is_sequence:
                emb = raw[key] * ids.mask.to(raw[key].dtype)[..., None]
                out[key] = (emb, ids.mask.bool())
            else:
                out[key] = _combine(raw[key], ids.mask, col.combiner)
        return out
