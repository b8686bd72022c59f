"""Layers of the port."""

from .interacting import InteractingLayer  # noqa: F401
from .mlp import Dense, MultiLayerDense, resolve_activation  # noqa: F401
