"""Typed configuration schema (a plain copy of ``recommendsystem_tpu/core/
config.py``: the port imports nothing of the JAX package).

Replaces the reference's three ad-hoc config styles (JSON feature config
``rank/ctr/model_parameter.json`` consumed at ``rank/ctr/base_model.py:35-86``,
Python Config classes ``staytime/config.py`` / ``rough_rank/config/config.py``,
and argv in the search tools) with one typed schema.

The load path for the reference JSON format is kept byte-compatible:
``{"feature_slot": {"sparse_feature": {name: {"emb_size": int, "slot_id":
[str], "bias"?: int, "bias_type"?: str}}, "sequence_feature": {...},
"dense_feature": {name: {"slot_id": str}}}}``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

BIAS_TYPES = ("ppnet", "can", "multiply_user", "multiply_item")


@dataclasses.dataclass
class FeatureConfig:
    """One sparse/sequence/dense feature from the model config."""

    name: str
    slot_id: str
    emb_size: int = 0
    kind: str = "sparse"          # sparse | sequence | dense
    bias_type: Optional[str] = None   # one of BIAS_TYPES when the feature is a bias column

    @property
    def is_bias(self) -> bool:
        return self.bias_type is not None


class SlotIntervals:
    """Packing of several features sharing one slot into one wide embedding row.

    Faithful re-implementation of the interval bookkeeping in the reference's
    ``SingleSlot`` (``rank/ctr/base_model.py:14-27``): features are appended in
    declaration order; each occupies ``[last_start, last_end]``; non-bias
    ("single") features are recorded in ``intervals`` (half-open ``[s, e)``),
    bias features only advance the cursor and are recorded per ``bias_type``.
    """

    def __init__(self, slot_id: str, emb_size: int, is_single: bool):
        self.slot_id = slot_id
        self.intervals: List[List[int]] = []
        self.last_start = -1
        self.last_end = -1
        self.total_emb_size = 0
        self.update_intervals(emb_size, is_single)

    def update_intervals(self, emb_size: int, is_single: bool) -> None:
        self.last_start = self.last_end + 1
        self.last_end = self.last_start + emb_size - 1
        if is_single:
            self.intervals.append([self.last_start, self.last_end + 1])
        self.total_emb_size += emb_size

    @property
    def last_interval(self) -> List[int]:
        return [self.last_start, self.last_end + 1]


@dataclasses.dataclass
class ModelConfig:
    """Parsed feature config + model hyper-parameters.

    ``slot_intervals`` maps slot_id -> SlotIntervals;
    ``bias_intervals`` maps slot_id -> {bias_type: [start, end)}.
    """

    sparse_features: Dict[str, FeatureConfig] = dataclasses.field(default_factory=dict)
    sequence_features: Dict[str, FeatureConfig] = dataclasses.field(default_factory=dict)
    dense_features: Dict[str, FeatureConfig] = dataclasses.field(default_factory=dict)
    slot_intervals: Dict[str, SlotIntervals] = dataclasses.field(default_factory=dict)
    bias_intervals: Dict[str, Dict[str, List[int]]] = dataclasses.field(default_factory=dict)
    model_param: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # feature_id -> shared table slot: distinct input columns whose ids index
    # ONE embedding table (the reference's hardcoded ``featureid_to_slot``,
    # ``rank/ctr/base_model.py:89-107``, made config-driven here)
    feature_id_remap: Dict[str, str] = dataclasses.field(default_factory=dict)

    def table_slot(self, slot_id: str) -> str:
        """The embedding-table key a feature slot binds to (identity unless
        remapped)."""
        return self.feature_id_remap.get(slot_id, slot_id)

    @property
    def max_embed_size(self) -> int:
        """All slots share one physical row width = max total size over slots
        (reference ``base_model.py:82-86,108,211``)."""
        if not self.slot_intervals:
            return 0
        return max(s.total_emb_size for s in self.slot_intervals.values())

    @property
    def sparse_slots(self) -> List[str]:
        """Sorted union of sparse+sequence slot ids (``base_model.py:71-74``)."""
        slots = {f.slot_id for f in self.sparse_features.values()}
        slots |= {f.slot_id for f in self.sequence_features.values()}
        return sorted(slots)

    @property
    def dense_slots(self) -> List[str]:
        return sorted(f.slot_id for f in self.dense_features.values())


def load_model_parameter_json(path_or_dict,
                              feature_id_remap: Optional[Dict[str, str]] = None
                              ) -> ModelConfig:
    """Parse the reference's ``model_parameter.json`` schema into a ModelConfig.

    Mirrors ``rank/ctr/base_model.py:35-86`` exactly, including:
    - slot sharing: features with the same ``slot_id[0]`` pack into one wide
      row, in dict order;
    - ``bias`` features advance the interval cursor without entering
      ``intervals``; their span is recorded per ``bias_type``;
    - a sequence feature must own a fresh slot (raises otherwise,
      ``base_model.py:64-67``).

    ``feature_id_remap`` (or a ``"featureid_to_slot"`` key in the JSON itself)
    maps feature slot ids onto shared embedding tables — the reference keeps
    this as a hardcoded dict (``base_model.py:89-98``); here it is part of
    the config.
    """
    if isinstance(path_or_dict, (str, bytes)):
        with open(path_or_dict) as f:
            raw = json.load(f)
    else:
        raw = path_or_dict

    cfg = ModelConfig(model_param=raw.get("model_param", {}))
    cfg.feature_id_remap = {str(k): str(v) for k, v in
                            (feature_id_remap
                             or raw.get("featureid_to_slot", {})).items()}
    fs = raw["feature_slot"]

    for name, spec in fs.get("sparse_feature", {}).items():
        slot = str(spec["slot_id"][0]) if isinstance(spec["slot_id"], list) else str(spec["slot_id"])
        is_bias = "bias" in spec
        if is_bias and "bias_type" not in spec:
            raise ValueError("bias_type could not be null")
        feat = FeatureConfig(name=name, slot_id=slot, emb_size=int(spec["emb_size"]),
                             kind="sparse", bias_type=spec.get("bias_type"))
        cfg.sparse_features[name] = feat
        if slot in cfg.slot_intervals:
            cfg.slot_intervals[slot].update_intervals(feat.emb_size, not is_bias)
        else:
            cfg.slot_intervals[slot] = SlotIntervals(slot, feat.emb_size, not is_bias)
        if is_bias:
            cfg.bias_intervals.setdefault(slot, {})[feat.bias_type] = (
                cfg.slot_intervals[slot].last_interval)

    for name, spec in fs.get("sequence_feature", {}).items():
        slot = str(spec["slot_id"][0]) if isinstance(spec["slot_id"], list) else str(spec["slot_id"])
        if slot in cfg.slot_intervals:
            raise ValueError(f"sequence feature {slot} has been defined more than once")
        feat = FeatureConfig(name=name, slot_id=slot, emb_size=int(spec["emb_size"]),
                             kind="sequence")
        cfg.sequence_features[name] = feat
        cfg.slot_intervals[slot] = SlotIntervals(slot, feat.emb_size, True)

    for name, spec in fs.get("dense_feature", {}).items():
        slot = str(spec["slot_id"])
        cfg.dense_features[name] = FeatureConfig(name=name, slot_id=slot, kind="dense")

    return cfg


def synthetic_ctr_config(num_slots: int = 24,
                         emb_sizes: Tuple[int, ...] = (8, 12, 16, 24, 32, 48),
                         num_bias: int = 8,
                         seed: int = 0) -> ModelConfig:
    """Generate a model_parameter.json-shaped config for tests/benchmarks.

    Produces the same structural variety as the reference config (212 features,
    shared slots, the four bias types — ``rank/ctr/model_parameter.json``)
    at configurable size, without copying the production feature list.
    """
    import random

    rng = random.Random(seed)
    sparse: Dict[str, Any] = {}
    for i in range(num_slots):
        slot = str(1000 + i)
        sparse[f"feat_{i}"] = {"emb_size": rng.choice(emb_sizes), "slot_id": [slot]}
    # bias features share the first num_bias slots (wide-row packing).  All
    # bias columns get one width so multiply_user/multiply_item concats match
    # elementwise (as the production config guarantees by construction).
    if num_bias % len(BIAS_TYPES) != 0:
        raise ValueError("num_bias must be a multiple of 4 (one per bias type)")
    for b in range(num_bias):
        slot = str(1000 + (b % num_slots))
        sparse[f"bias_feat_{b}"] = {
            "emb_size": 8,
            "slot_id": [slot],
            "bias": 1,
            "bias_type": BIAS_TYPES[b % len(BIAS_TYPES)],
        }
    raw = {"feature_slot": {"sparse_feature": sparse, "sequence_feature": {},
                            "dense_feature": {}}}
    return load_model_parameter_json(raw)
