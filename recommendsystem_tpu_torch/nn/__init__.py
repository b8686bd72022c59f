"""Layers of the port."""

from .dcn import DeepCrossLayer  # noqa: F401
from .din import MASK_PAD, DINPool, sequence_mask  # noqa: F401
from .fm import DeepFMLayer, FFMBlock, fm_cross_term  # noqa: F401
from .interacting import InteractingLayer  # noqa: F401
from .mlp import (Dense, MultiLayerDense, glorot_normal_, kernel_penalty,  # noqa: F401
                  regularized_kernels, resolve_activation, truncated_normal)
from .ppnet import PPNetGateBank  # noqa: F401
from .senet import SENet  # noqa: F401
