"""Sparse-embedding engine of the port: feature columns, the engine (local
and sharded: the all-to-all pull and push) and the fused gather-and-fold
lookup."""

from .feature_column import (  # noqa: F401
    CategoryColumn,
    EmbeddingColumn,
    Feature,
    FeatureSlot,
    category_column,
    embedding_column,
)
from .optimizers import SparseAdaGrad, SparseAdam, make_sparse_optimizer  # noqa: F401
from .engine import EmbeddingFeatures, IdBatch, all_to_all_lookup, validate_batch  # noqa: F401
