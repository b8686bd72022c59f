"""Layers of the port."""

from .dcn import DeepCrossLayer  # noqa: F401
from .din import MASK_PAD, DINPool, sequence_mask  # noqa: F401
from .fm import FFMBlock, fm_cross_term  # noqa: F401
from .interacting import InteractingLayer  # noqa: F401
from .mlp import Dense, MultiLayerDense, resolve_activation, truncated_normal  # noqa: F401
from .ppnet import PPNetGateBank  # noqa: F401
from .senet import SENet  # noqa: F401
