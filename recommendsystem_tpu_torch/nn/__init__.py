"""Layers of the port."""

from .dcn import CrossNet, DeepCrossLayer, LowRankCrossNet  # noqa: F401
from .din import MASK_PAD, DINAttention, DINPool, sequence_mask  # noqa: F401
from .fm import DeepFMLayer, FFMBlock, FMLayer3D, fm_cross_term  # noqa: F401
from .interacting import InteractingLayer  # noqa: F401
from .mlp import (DNN, Dense, MultiLayerDense, dot_f32, einsum_f32,  # noqa: F401
                  glorot_normal_, kernel_penalty, matmul_promoted, regularized_kernels,
                  resolve_activation, truncated_normal)
from .moe import MMOE, PLE  # noqa: F401
from .moe_stacked import (GatedExpert, MMOEStacked, PLEStacked,  # noqa: F401
                          expert_shardings, stacked_gated_experts)
from .ppnet import GateTower, PPNetGateBank  # noqa: F401
from .senet import SENet  # noqa: F401
from .similarity import Similarity, kd_loss  # noqa: F401
