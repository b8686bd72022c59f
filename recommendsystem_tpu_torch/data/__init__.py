"""Data plane of the port: TFRecord shards of tf.Example records (the
pure-Python codec and reader, and the C++ loader bound with ctypes), their
parse into batches of CPU tensors, the pipeline that copies them to the
card, Criteo TSV support, staytime labels and synthetic batches."""

from .parse import pad_ids  # noqa: F401
from .staytime_labels import BIN_LIST, staytime_labels  # noqa: F401
from .synthetic import synthetic_batch  # noqa: F401
