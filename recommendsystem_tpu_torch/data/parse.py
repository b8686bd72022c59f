"""tf.Example -> model batch parsing.

Counterpart of ``recommendsystem_tpu/data/parse.py``: the reference's
``parse_input_func`` contract (``staytime/parse.py:12-15``: fixed
signature, returns (features, labels[, sample_weight])) with the
framework's static-shape format: VarLen int64 feasigns become padded int32
row ids + masks via each column's category hash.

The ids, masks, labels, weights and dense inputs come out as CPU tensors
(the loader pins them and copies them to the card); ``extras`` (example
ids, ``video_duration``) stay numpy: strings and host data.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..embedding.engine import EmbeddingFeatures, IdBatch
from .example_proto import decode_example
from .staytime_labels import staytime_labels


def decode_batch(raw_batch: Sequence[bytes]) -> List[dict]:
    """Decode a record batch, keeping malformed protos as empty dicts (the
    reference's robustness posture: bad rows are dropped,
    ``pso/reader.py:23``; an empty row gets zero embeddings and keeps the
    batch's shape)."""
    out: List[dict] = []
    for r in raw_batch:
        try:
            out.append(decode_example(r))
        except (IndexError, ValueError, struct.error):
            out.append({})
    return out


def pad_ids(values: List[List[int]], max_len: int, hash_fn) -> IdBatch:
    """Ragged int64 feasigns -> (B, max_len) int32 rows + float mask, as CPU
    tensors.  Overflow ids beyond max_len are dropped (static-shape
    contract); padding carries id 0."""
    b = len(values)
    rows = np.zeros((b, max_len), np.int32)
    mask = np.zeros((b, max_len), np.float32)
    for i, vals in enumerate(values):
        vals = vals[:max_len]
        if vals:
            rows[i, :len(vals)] = hash_fn(np.asarray(vals, np.int64))
            mask[i, :len(vals)] = 1.0
    return IdBatch(rows=torch.from_numpy(rows), mask=torch.from_numpy(mask))


def examples_to_batch(examples: List[dict], embedding: EmbeddingFeatures,
                      ids_per_feature: int = 5) -> Dict[str, IdBatch]:
    """The per-column IdBatch dict an EmbeddingFeatures lookup expects.

    Non-sequence columns pad to ``ids_per_feature``; sequence columns pad to
    their ``seq_max_len``.  Slot values come from the feature keyed by the
    column's categorical key (both mean and seq columns of one slot read the
    same VarLen feature, as in ``staytime/VideoDnn.py:217-231``).
    """
    batch: Dict[str, IdBatch] = {}
    for key, col in embedding.columns.items():
        fkey = col.categorical_column.key
        values = [ex.get(fkey, []) for ex in examples]
        max_len = col.seq_max_len if col.is_sequence else ids_per_feature
        batch[key] = pad_ids(values, max_len, col.categorical_column.hash_ids)
    return batch


def make_staytime_parse_fn(embedding: EmbeddingFeatures,
                           task_prefix: str = "video_id_rank_staytime_mtl_ppnet_v7",
                           ids_per_feature: int = 5):
    """The ``staytime/parse.py:16-71`` contract: raw record batch ->
    (batch, dense_inputs, labels, sample_weight, extras)."""

    def parse_fn(raw_batch: Sequence[bytes]):
        examples = decode_batch(raw_batch)
        batch = examples_to_batch(examples, embedding, ids_per_feature)
        wt = np.array([ex.get("watch_duration", [0])[0] for ex in examples],
                      np.int64)
        extra = np.array([
            (ex.get("extra_info", [b"label"])[0] or b"label").decode("utf-8", "replace")
            for ex in examples])
        labels_raw, weight = staytime_labels(wt, extra)
        labels = {f"{task_prefix}_{name}": torch.from_numpy(labels_raw[name])
                  for name in ("staytime", "shortplay", "longplay")}
        extras = {"example_id": extra,
                  "video_duration": np.array(
                      [ex.get("video_duration", [0])[0] for ex in examples])}
        return batch, None, labels, torch.from_numpy(weight), extras

    return parse_fn


def make_ctr_parse_fn(embedding: EmbeddingFeatures, label_key: str,
                      task_name: str, ids_per_feature: int = 5,
                      dense_keys: Tuple[str, ...] = ()):
    """Generic single-binary-label CTR parser: raw record batch -> (batch,
    dense_inputs, {task_name: (B, 1)}, sample_weight of ones, extras)."""

    def parse_fn(raw_batch: Sequence[bytes]):
        examples = decode_batch(raw_batch)
        batch = examples_to_batch(examples, embedding, ids_per_feature)
        y = np.array([[float(ex.get(label_key, [0])[0])] for ex in examples],
                     np.float32)
        dense = None
        if dense_keys:
            dense = {k: torch.from_numpy(np.array(
                [[float(ex.get(k, [0.0])[0])] for ex in examples], np.float32))
                for k in dense_keys}
        extras = {"example_id": np.array([
            (ex.get("extra_info", [str(i).encode()])[0]).decode("utf-8", "replace")
            for i, ex in enumerate(examples)])}
        return (batch, dense, {task_name: torch.from_numpy(y)},
                torch.ones(y.shape, dtype=torch.float32), extras)

    return parse_fn
