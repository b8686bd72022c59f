"""Criteo click-log format support.

Counterpart of ``recommendsystem_tpu/data/criteo.py``.  BASELINE.md
measures AUC parity on "Criteo/Avazu-style CTR data".  The Criteo format is
TSV: label, 13 integer count features (I1-I13), 26 hex-hashed categorical
features (C1-C26).  Mapping onto the framework's slot model (standard
practice for slot-based trainers):

- C1..C26 -> sparse slots "c1".."c26", the hex token hashed as a feasign;
- I1..I13 -> sparse slots "i1".."i13" via log2 bucketization
  (``bucket = floor(log2(1+x))``), which is how PS-style trainers ingest
  Criteo's heavy-tailed counts;
- empty fields -> no ids for that slot (the mean combiner yields zeros).

Batches come out as CPU tensors, as ``data/parse.py`` makes them.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from ..embedding.engine import EmbeddingFeatures
from ..embedding.feature_column import category_column, embedding_column
from ..embedding.optimizers import SparseAdam
from .parse import pad_ids

NUM_INT = 13
NUM_CAT = 26
INT_SLOTS = tuple(f"i{i}" for i in range(1, NUM_INT + 1))
CAT_SLOTS = tuple(f"c{i}" for i in range(1, NUM_CAT + 1))
ALL_SLOTS = INT_SLOTS + CAT_SLOTS


def criteo_embedding(dim: int = 8, bucket_size: int = 265000,
                     sparse_opt=None, group_tables: bool = True) -> EmbeddingFeatures:
    """39 mean columns of width ``dim``, lazy Adam by default."""
    cols = [embedding_column(category_column(s, bucket_size), dim,
                             combiner="mean") for s in ALL_SLOTS]
    return EmbeddingFeatures(cols, sparse_opt or SparseAdam(),
                             group_tables=group_tables)


def parse_line(line: str) -> Tuple[float, List[List[int]]]:
    """One Criteo TSV line -> (label, per-slot feasign lists)."""
    parts = line.rstrip("\n").split("\t")
    label = float(parts[0])
    feats: List[List[int]] = []
    for i in range(NUM_INT):
        tok = parts[1 + i] if 1 + i < len(parts) else ""
        if tok == "":
            feats.append([])
        else:
            v = int(tok)
            bucket = int(math.floor(math.log2(1 + v))) if v > 0 else v
            feats.append([bucket])
    for i in range(NUM_CAT):
        tok = parts[1 + NUM_INT + i] if 1 + NUM_INT + i < len(parts) else ""
        feats.append([int(tok, 16)] if tok else [])
    return label, feats


def make_criteo_parse_fn(embedding: EmbeddingFeatures,
                         task_name: str = "video_id_rank_skip_model"):
    """Text-line batch -> (batch, dense, labels, weight, extras); the integer
    slots pad to 1 id, the categorical ones to 2."""

    def parse_fn(lines: Sequence[str]):
        labels = np.zeros((len(lines), 1), np.float32)
        per_slot: List[List[List[int]]] = [[] for _ in ALL_SLOTS]
        for r, line in enumerate(lines):
            y, feats = parse_line(line)
            labels[r, 0] = y
            for si, vals in enumerate(feats):
                per_slot[si].append(vals)
        batch = {}
        for key, col in embedding.columns.items():
            si = ALL_SLOTS.index(col.categorical_column.key)
            batch[key] = pad_ids(per_slot[si], 1 if si < NUM_INT else 2,
                                 col.categorical_column.hash_ids)
        weight = torch.ones(labels.shape, dtype=torch.float32)
        return batch, None, {task_name: torch.from_numpy(labels)}, weight, {}

    return parse_fn


def criteo_dataset(path: str, batch_size: int, embedding: EmbeddingFeatures,
                   task_name: str = "video_id_rank_skip_model",
                   drop_remainder: bool = True) -> Iterator:
    """Stream a Criteo TSV file as model batches (CPU tensors)."""
    parse_fn = make_criteo_parse_fn(embedding, task_name)

    def gen():
        buf: List[str] = []
        with open(path) as f:
            for line in f:
                buf.append(line)
                if len(buf) == batch_size:
                    yield parse_fn(buf)
                    buf = []
        if buf and not drop_remainder:
            yield parse_fn(buf)

    return gen()


def criteo_autoint(dim: int = 8, bucket_size: int = 265000, **kwargs):
    """AutoInt bundle wired for the 39 Criteo slots (BASELINE 'AutoInt
    stacked: 39-field Criteo' config); ``kwargs`` go to the autoint factory
    (``sparse_lr``, ``dense_lr``, ``device``, ...)."""
    from ..core.config import load_model_parameter_json
    from ..models import create_model

    raw = {"feature_slot": {
        "sparse_feature": {s: {"emb_size": dim, "slot_id": [s]} for s in ALL_SLOTS},
        "sequence_feature": {}, "dense_feature": {}}}
    cfg = load_model_parameter_json(raw)
    return create_model("autoint", cfg=cfg, bucket_size=bucket_size, **kwargs)


def write_synthetic_criteo(path: str, n: int, seed: int = 0) -> None:
    """Synthetic file in the exact Criteo TSV format with a planted signal."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            engagement = rng.uniform()
            p = 1.0 / (1.0 + math.exp(-(engagement * 4 - 2)))
            label = int(rng.uniform() < p)
            ints = []
            for i in range(NUM_INT):
                if rng.uniform() < 0.1:
                    ints.append("")
                else:
                    ints.append(str(int(engagement * 100 * (i + 1) * rng.uniform(0.5, 1.5))))
            cats = []
            for i in range(NUM_CAT):
                if rng.uniform() < 0.05:
                    cats.append("")
                else:
                    v = int(engagement * 16 + rng.integers(0, 8)) * (i + 1)
                    cats.append(format(v, "08x"))
            f.write("\t".join([str(label)] + ints + cats) + "\n")
