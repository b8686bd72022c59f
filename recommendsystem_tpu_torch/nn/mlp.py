"""Dense / MLP building blocks with Keras-matching defaults.

Counterpart of ``recommendsystem_tpu/nn/mlp.py``: glorot-uniform kernels and
zero biases, as ``tf.keras.layers.Dense``.  Kernels keep the flax layout
``(in, out)`` and the layer computes ``x @ kernel + bias``, so weights carry
across from the JAX package without a transpose.  Parameter names follow
flax (``kernel``, ``bias``; ``dense_{i}`` inside ``MultiLayerDense``), so a
flattened flax parameter tree is a state dict of these modules.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch
from torch import nn

ACTIVATIONS = {
    None: lambda x: x,
    "linear": lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
}


def resolve_activation(act) -> Callable:
    if callable(act):
        return act
    try:
        return ACTIVATIONS[act]
    except KeyError:
        raise ValueError(f"unknown activation {act!r}")


def glorot_uniform_(w: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Keras glorot_uniform of an ``(in, out)`` kernel: U(-a, a),
    a = sqrt(6 / (in + out))."""
    fan_in, fan_out = w.shape
    a = (6.0 / (fan_in + fan_out)) ** 0.5
    with torch.no_grad():
        return w.uniform_(-a, a, generator=generator)


def truncated_normal(stddev: float) -> Callable:
    """flax's ``initializers.truncated_normal(stddev)``: N(0, 1) cut at
    +-2, times ``stddev / 0.87962566103423978`` (the std of the cut normal),
    as an initializer ``(w, generator) -> w``."""
    def init_(w: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with torch.no_grad():
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            return w.mul_(stddev / 0.87962566103423978)
    return init_


class Dense(nn.Module):
    """Keras-parity Dense: ``activation(x @ kernel + bias)``.

    ``kernel_init`` is an initializer ``(w, generator) -> w`` (glorot
    uniform by default, or ``truncated_normal(stddev)``).
    ``kernel_regularizer=(l1, l2)`` mirrors ``tf.keras.regularizers.L1L2``
    as the flax layer does; it is stored here, and the penalty it adds to
    the training loss comes with the train step of the models that use it
    (``make_train_step`` refuses a module that holds one meanwhile)."""

    def __init__(self, in_features: int, features: int, activation: Any = None,
                 use_bias: bool = True, kernel_init: Callable = glorot_uniform_,
                 kernel_regularizer: Optional[Tuple[float, float]] = None,
                 device=None):
        super().__init__()
        self.activation = resolve_activation(activation)
        self.kernel_init = kernel_init
        self.kernel_regularizer = kernel_regularizer
        self.kernel = nn.Parameter(torch.empty((in_features, features),
                                               device=device))
        self.bias = (nn.Parameter(torch.empty((features,), device=device))
                     if use_bias else None)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.kernel_init(self.kernel, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        if self.bias is not None:
            y = y + self.bias
        return self.activation(y)


class MultiLayerDense(nn.Module):
    """Stack of Dense layers with one activation."""

    def __init__(self, in_features: int, units: Sequence[int],
                 activation: Any = "relu", device=None):
        super().__init__()
        self.n = len(units)
        for i, unit in enumerate(units):
            setattr(self, f"dense_{i}", Dense(in_features, unit, activation,
                                              device=device))
            in_features = unit

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
        return x
