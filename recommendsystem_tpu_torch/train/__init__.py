"""Train state and steps of the port (the predict step so far)."""

from .state import TrainState, create_train_state  # noqa: F401
from .step import apply_model, make_predict_step  # noqa: F401
