"""Feature columns: the tensornet surface the models use.

Counterpart of ``recommendsystem_tpu/embedding/feature_column.py``:
``FeatureSlot`` and ``Feature`` (a feature bound to the slot, one logical
table, it shares), ``category_column`` and ``embedding_column``.  Raw
int64 feature values ("feasigns") are hashed on the host with splitmix64
into the ``bucket_size`` row space, bit for bit as the JAX package does, so
both packages send the same int32 row ids to their tables.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mixer (public-domain splitmix64 constants), in
    wrapping uint64 arithmetic."""
    x = x.astype(np.uint64, copy=True)
    x += np.uint64(0x9E3779B97F4A7C15)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


@dataclasses.dataclass(frozen=True)
class FeatureSlot:
    """Registry key for one logical embedding table."""

    slot_id: str


@dataclasses.dataclass(frozen=True)
class Feature:
    """feature -> slot binding; ``sparse=False`` marks a dense passthrough."""

    feature_id: Optional[str] = None
    feature_slot: Optional[FeatureSlot] = None
    sparse: bool = True
    feature_name: Optional[str] = None

    @property
    def slot_id(self) -> Optional[str]:
        return self.feature_slot.slot_id if self.feature_slot else None

    def __lt__(self, other):  # the reference sorts (feature, emb) pairs
        return str(self.feature_id) < str(other.feature_id)


@dataclasses.dataclass(frozen=True)
class CategoryColumn:
    """``category_column(key, bucket_size)``: feasign -> row id in [0, bucket)."""

    key: str
    bucket_size: int

    def hash_ids(self, feasigns: np.ndarray) -> np.ndarray:
        """Host-side: raw int64 feasigns -> int32 table rows."""
        mixed = _splitmix64(np.asarray(feasigns))
        return (mixed % np.uint64(self.bucket_size)).astype(np.int32)


def category_column(key: str, bucket_size: int) -> CategoryColumn:
    return CategoryColumn(key=key, bucket_size=bucket_size)


@dataclasses.dataclass(frozen=True)
class EmbeddingColumn:
    """``embedding_column``: per-column dim + combiner.

    ``combiner='mean'`` -> masked mean over the ids of a sample;
    ``combiner=None`` + ``seq_max_len`` -> a sequence column, whose lookup
    returns ``((B, T, D) embeddings, (B, T) mask)``."""

    categorical_column: CategoryColumn
    dimension: int
    combiner: Optional[str] = "mean"
    seq_max_len: Optional[int] = None
    name: Optional[str] = None

    @property
    def key(self) -> str:
        return self.name or self.categorical_column.key

    @property
    def is_sequence(self) -> bool:
        return self.combiner is None


def embedding_column(categorical_column: CategoryColumn, dimension: int,
                     combiner: Optional[str] = "mean",
                     seq_max_len: Optional[int] = None,
                     name: Optional[str] = None) -> EmbeddingColumn:
    if combiner not in ("mean", "sum", "sqrtn", None):
        raise ValueError(f"unsupported combiner {combiner!r}")
    if combiner is None and seq_max_len is None:
        raise ValueError("sequence columns (combiner=None) need seq_max_len")
    return EmbeddingColumn(categorical_column=categorical_column, dimension=dimension,
                           combiner=combiner, seq_max_len=seq_max_len, name=name)
