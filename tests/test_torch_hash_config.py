"""Port parity: feature hashing, configs and the engine's storage grouping
equal the JAX package's, exactly (integer and structural results)."""

import dataclasses

import numpy as np
import pytest
import torch

from recommendsystem_tpu.core import config as jcfg
from recommendsystem_tpu.embedding import feature_column as jfc
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu_torch.core import config as pcfg
from recommendsystem_tpu_torch.embedding import feature_column as pfc
from recommendsystem_tpu_torch.models import create_model

torch.set_num_threads(1)


@pytest.mark.parametrize("bucket", [1, 256, 265000, (1 << 31) - 1])
def test_hash_ids_bit_equal(bucket):
    rng = np.random.default_rng(bucket % 97)
    feasigns = np.concatenate([
        rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                     size=4096, dtype=np.int64),
        np.array([0, 1, -1, np.iinfo(np.int64).max, np.iinfo(np.int64).min]),
    ])
    want = jfc.category_column("k", bucket).hash_ids(feasigns)
    got = pfc.category_column("k", bucket).hash_ids(feasigns)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _config_view(cfg):
    return {
        "sparse": {k: dataclasses.asdict(v) for k, v in cfg.sparse_features.items()},
        "sequence": {k: dataclasses.asdict(v) for k, v in cfg.sequence_features.items()},
        "dense": {k: dataclasses.asdict(v) for k, v in cfg.dense_features.items()},
        "slots": [(k, v.intervals, v.last_start, v.last_end, v.total_emb_size)
                  for k, v in cfg.slot_intervals.items()],
        "bias": cfg.bias_intervals,
        "model_param": cfg.model_param,
        "remap": cfg.feature_id_remap,
        "max_embed_size": cfg.max_embed_size,
        "sparse_slots": cfg.sparse_slots,
        "dense_slots": cfg.dense_slots,
    }


@pytest.mark.parametrize("kwargs", [
    {},
    {"num_slots": 24, "emb_sizes": (8,), "num_bias": 0},
    {"num_slots": 180, "num_bias": 32, "seed": 3},
])
def test_synthetic_ctr_config_equal(kwargs):
    assert (_config_view(pcfg.synthetic_ctr_config(**kwargs))
            == _config_view(jcfg.synthetic_ctr_config(**kwargs)))


def test_load_model_parameter_json_equal():
    raw = {
        "model_param": {"mlp": {"hidden_units": [4]}},
        "featureid_to_slot": {"7": "5"},
        "feature_slot": {
            "sparse_feature": {
                "a": {"emb_size": 8, "slot_id": ["5"]},
                "b": {"emb_size": 8, "slot_id": ["5"], "bias": 1,
                      "bias_type": "ppnet"},
                "c": {"emb_size": 4, "slot_id": "6"},
            },
            "sequence_feature": {"s": {"emb_size": 8, "slot_id": ["9"]}},
            "dense_feature": {"d": {"slot_id": "11"}},
        },
    }
    assert (_config_view(pcfg.load_model_parameter_json(raw))
            == _config_view(jcfg.load_model_parameter_json(raw)))


@pytest.mark.parametrize("bucket", [256, 265000])
def test_autoint_storage_grouping_equal(bucket):
    """bucket 256: all 24 tables in one storage (C = 24); full width: one
    storage per table (C = 1), rows padded to 265104 as in the JAX engine."""
    jeng = jax_create_model("autoint", bucket_size=bucket).embedding
    peng = create_model("autoint", bucket_size=bucket, device="cpu").embedding
    assert peng.storage == jeng.storage
    assert peng.table_map == jeng.table_map
    assert list(peng.columns) == list(jeng.columns)
    if bucket == 265000:
        assert set(peng.storage.values()) == {(265104, 8)}
        assert len(peng.storage) == 24
    else:
        assert list(peng.storage.values()) == [(24 * 336, 8)]
