"""Dense / MLP building blocks with Keras-matching defaults.

Counterpart of ``recommendsystem_tpu/nn/mlp.py``: glorot-uniform kernels and
zero biases, as ``tf.keras.layers.Dense``.  Kernels keep the flax layout
``(in, out)`` and the layer computes ``x @ kernel + bias``, so weights carry
across from the JAX package without a transpose.  Parameter names follow
flax (``kernel``, ``bias``; ``dense_{i}`` inside ``MultiLayerDense``), so a
flattened flax parameter tree is a state dict of these modules.

``kernel_penalty(regularized_kernels(module), params)`` is the L1L2 penalty
of every Dense that carries a ``kernel_regularizer``, computed from a
parameter dict: the sum that the JAX ``Dense`` sows into its ``"losses"``
collection and the JAX train step adds to the loss.  The train step finds
those kernels once and computes the penalty each step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

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


# the standard deviation of N(0, 1) cut at +-2
_TRUNCATED_STD = 0.87962566103423978


def truncated_normal(stddev: float) -> Callable:
    """flax's ``initializers.truncated_normal(stddev)``: N(0, 1) cut at
    +-2, times ``stddev`` (so the values' own std is 0.88 ``stddev``, as
    Keras's ``TruncatedNormal``), as an initializer ``(w, generator) ->
    w``."""
    def init_(w: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with torch.no_grad():
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            return w.mul_(stddev)
    return init_


def glorot_normal_(w: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``initializers.glorot_normal()`` of an ``(in, out)`` kernel:
    N(0, 1) cut at +-2, scaled so that the values' std is sqrt(2 / (in +
    out)) (``variance_scaling(1, "fan_avg", "truncated_normal")``)."""
    fan_in, fan_out = w.shape
    stddev = (2.0 / (fan_in + fan_out)) ** 0.5 / _TRUNCATED_STD
    return truncated_normal(stddev)(w, generator)


class Dense(nn.Module):
    """Keras-parity Dense: ``activation(x @ kernel + bias)``.

    ``kernel_init`` is an initializer ``(w, generator) -> w`` (glorot
    uniform by default, or ``truncated_normal(stddev)``).
    ``kernel_regularizer=(l1, l2)`` mirrors ``tf.keras.regularizers.L1L2``
    as the flax layer does.  The layer only stores it: the train step adds
    ``kernel_penalty`` to its loss, from the step's parameters, so a
    Dense that is built but never called (multi_head's
    eighth expert) still counts, as in the JAX package, whose Dense sows
    its penalty in the call that builds it."""

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


def regularized_kernels(module: nn.Module) -> Dict[Tuple[float, float], List[str]]:
    """The kernels that carry an L1L2 penalty in ``module``: {(l1, l2):
    [parameter name of each such Dense's kernel]}, in module order; empty
    when no Dense carries one.  The train step builds it once."""
    groups: Dict[Tuple[float, float], List[str]] = {}
    for name, mod in module.named_modules():
        if isinstance(mod, Dense) and mod.kernel_regularizer is not None:
            groups.setdefault(tuple(mod.kernel_regularizer), []).append(f"{name}.kernel")
    return groups


def kernel_penalty(groups: Mapping[Tuple[float, float], Sequence[str]],
                   params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """l1 sum |K| + l2 sum K^2 over the kernels of ``groups`` (non-empty,
    as ``regularized_kernels`` gives it), a 0-d tensor: the sum of what each
    JAX ``Dense`` sows.  The kernels of one (l1, l2) are concatenated, so the
    penalty takes a few kernels a group, not a few a layer.  |K| is
    ``where(K >= 0, K, -K)``, so that its derivative at 0 is +1 as
    ``jax.grad(jnp.abs)`` takes it (``torch.abs`` passes 0 there); a term
    whose coefficient is 0 is left out (its value and gradient are 0 either
    way)."""
    terms = []
    for (l1, l2), names in groups.items():
        k = torch.cat([params[n].reshape(-1) for n in names])
        if l1:
            terms.append(l1 * torch.where(k >= 0, k, -k).sum())
        if l2:
            terms.append(l2 * (k * k).sum())
    return sum(terms[1:], terms[0])
