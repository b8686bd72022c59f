"""Configuration schema, device set-up, and the process mesh of the
sharded mode with its model axis (``model_axis``: the collectives of
tensor and expert parallelism)."""

from .config import (  # noqa: F401
    FeatureConfig,
    ModelConfig,
    SlotIntervals,
    load_model_parameter_json,
    synthetic_ctr_config,
)
from .device import resolve_device  # noqa: F401
from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    create_mesh,
    local_mesh,
    process_count,
    process_index,
)
