"""Sparse-embedding engine of the port: feature columns, the local engine
and the fused gather-and-fold lookup."""

from .feature_column import (  # noqa: F401
    CategoryColumn,
    EmbeddingColumn,
    category_column,
    embedding_column,
)
from .engine import EmbeddingFeatures, IdBatch, validate_batch  # noqa: F401
