"""Data helpers of the port: id padding and synthetic batches."""

from .parse import pad_ids  # noqa: F401
from .synthetic import synthetic_batch  # noqa: F401
