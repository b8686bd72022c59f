"""Train state and steps of the port: the packed train step, its
multi-step driver and the predict step."""

from .state import TrainState, create_train_state  # noqa: F401
from .step import (  # noqa: F401
    apply_model,
    make_predict_step,
    make_scan_train_step,
    make_train_step,
)
