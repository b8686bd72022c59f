"""Online scoring service of the port."""

from .server import ScoringService, serve  # noqa: F401
