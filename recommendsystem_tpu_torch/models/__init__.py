"""Model zoo of the port (autoint and staytime so far)."""

from .base import MODEL_REGISTRY, ModelBundle, create_model, register_model  # noqa: F401
from . import autoint  # noqa: F401
from . import staytime  # noqa: F401
