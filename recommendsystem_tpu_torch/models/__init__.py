"""Model zoo of the port: autoint, ctr, finish, multi_head, rough_rank and staytime."""

from .base import MODEL_REGISTRY, ModelBundle, create_model, register_model  # noqa: F401
from . import autoint  # noqa: F401
from . import ctr  # noqa: F401
from . import finish  # noqa: F401
from . import multi_head  # noqa: F401
from . import rough_rank  # noqa: F401
from . import staytime  # noqa: F401
