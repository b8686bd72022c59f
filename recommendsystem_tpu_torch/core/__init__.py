"""Configuration schema and device set-up."""

from .config import (  # noqa: F401
    FeatureConfig,
    ModelConfig,
    SlotIntervals,
    load_model_parameter_json,
    synthetic_ctr_config,
)
from .device import resolve_device  # noqa: F401
