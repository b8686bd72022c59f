"""Dense / MLP building blocks with Keras-matching defaults.

Counterpart of ``recommendsystem_tpu/nn/mlp.py``: glorot-uniform kernels and
zero biases, as ``tf.keras.layers.Dense``.  Kernels keep the flax layout
``(in, out)`` and the layer computes ``x @ kernel + bias``, so weights carry
across from the JAX package without a transpose.  Parameter names follow
flax (``kernel``, ``bias``; ``dense_{i}`` inside ``MultiLayerDense``), so a
flattened flax parameter tree is a state dict of these modules.

``DNN`` is the generic MLP of rough_rank (glorot-normal kernels
``kernel{i}``, zero biases ``bias{i}``, an ``output_activation`` for the
last layer).  ``Dense`` and ``DNN`` take ``stack=E`` for E experts whose
parameters are stacked on a leading axis, as flax's ``nn.vmap`` leaves
them (a kernel of shape (E, in, out)): the layer then maps (B, in) or (E,
B, in) to (E, B, out) in one batched product.

Products follow the JAX package's dtypes under the bf16 compute policy
(``train.step.apply_model``).  ``dot_f32`` is ``jnp.dot(...,
preferred_element_type=jnp.float32)``, the JAX layers' product: a float32
result whatever the operands (bf16 x bf16 exact products summed in float32;
a bf16 operand beside a float32 one widened exactly), so a Dense on bf16
inputs and weights gives float32, and later layers multiply float32
activations by bf16-rounded weights.  ``matmul_promoted`` is a JAX product
without ``preferred_element_type``: it computes and returns the promoted
type (bf16 x bf16 gives bf16).

``kernel_penalty(regularized_kernels(module), params)`` is the L1L2 penalty
of every layer that carries one (a Dense's ``kernel_regularizer``, a DNN's
or CrossNet's ``l2_reg``), computed from a parameter dict: the sum that the
JAX layers sow into their ``"losses"`` collection and the JAX train step
adds to the loss (a stacked kernel's penalty summed over its experts, as
the step sums every leaf).  The train step finds those kernels once and
computes the penalty each step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.model_axis import current, gather_from_model, sum_over_model

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
    its penalty in the call that builds it.

    ``stack=E`` stacks E such layers (flax's ``nn.vmap`` of a Dense): the
    kernel is (E, in, out), each expert's drawn on its own, the bias (E,
    out), and the layer maps (B, in) or (E, B, in) to (E, B, out)."""

    def __init__(self, in_features: int, features: int, activation: Any = None,
                 use_bias: bool = True, kernel_init: Callable = glorot_uniform_,
                 kernel_regularizer: Optional[Tuple[float, float]] = None,
                 stack: Optional[int] = None, device=None):
        super().__init__()
        self.activation = resolve_activation(activation)
        self.kernel_init = kernel_init
        self.kernel_regularizer = kernel_regularizer
        self.features = features
        lead = () if stack is None else (stack,)
        self.kernel = nn.Parameter(torch.empty(lead + (in_features, features),
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(lead + (features,), device=device))
                     if use_bias else None)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_kernel(self.kernel_init, self.kernel, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def penalized_kernels(self) -> Dict[str, Tuple[float, float]]:
        return {} if self.kernel_regularizer is None else {
            "kernel": tuple(self.kernel_regularizer)}

    def model_axis_reads(self) -> Dict[str, str]:
        return {"kernel": "column"} if self.kernel.ndim == 2 else {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.activation(model_affine(x, self.kernel, self.bias, self.features))


def init_kernel(init: Callable, kernel: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> None:
    """``init`` on an (in, out) kernel, or on each expert's (in, out) slice
    of an (E, in, out) stack (each drawn with its own fans, as flax's
    ``nn.vmap`` initializes each expert)."""
    if kernel.ndim == 2:
        init(kernel, generator)
    else:
        for e in range(kernel.shape[0]):
            init(kernel[e], generator)


class _Bf16ProductF32(torch.autograd.Function):
    """a @ b of two bf16 CUDA tensors on the tensor cores with float32
    accumulation and a float32 result (``torch.mm`` / ``torch.bmm`` with
    ``out_dtype``), for b (K, N) with a (..., K), or b (E, K, N) with a
    (M, K) or (E, M, K).  The backward is the widened product's (float32
    products of the float32 cotangent), rounded once to bf16: the cotangent
    that JAX's transpose of a ``preferred_element_type=float32`` dot gives a
    bf16 operand."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        f32 = torch.float32
        if b.ndim == 2:
            out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=f32)
            return out.reshape(*a.shape[:-1], b.shape[-1])
        if a.ndim == 2:
            a = a.expand(b.shape[0], *a.shape)
        return torch.bmm(a, b, out_dtype=f32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with torch.enable_grad():
            af = a.detach().float().requires_grad_(ctx.needs_input_grad[0])
            bf = b.detach().float().requires_grad_(ctx.needs_input_grad[1])
            out = af @ bf
        wrt = [t for t in (af, bf) if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, g))
        return tuple(next(grads).to(torch.bfloat16) if t.requires_grad else None
                     for t in (af, bf))


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(a, b, preferred_element_type=jnp.float32)`` for a @ b as
    ``torch.matmul`` broadcasts it: a float32 result.  Two bf16 CUDA
    operands go to the tensor cores (``_Bf16ProductF32``); otherwise each
    operand is widened to float32 (exact) and the product is a float32 one
    (TF32 off, ``core.device``), as XLA computes a bf16 x bf16 or mixed
    product with a float32 result on the CPU."""
    if (a.dtype == b.dtype == torch.bfloat16 and a.is_cuda
            and (b.ndim == 2 or (b.ndim == 3 and a.ndim in (2, 3)))):
        return _Bf16ProductF32.apply(a, b)
    return a.float() @ b.float()


def einsum_f32(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(..., preferred_element_type=jnp.float32)``: the
    operands widened to float32 (exact), a float32 result."""
    return torch.einsum(equation, *(o.float() for o in operands))


def matmul_promoted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A JAX ``@`` with no ``preferred_element_type``: both operands in
    their promoted type, which is the result's (bf16 x bf16 gives bf16,
    summed in float32 and rounded once; bf16 x float32 gives float32)."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t) @ b.to(t)


def affine(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ kernel + bias`` with the JAX ``Dense``'s dtypes: the product in
    float32 (``dot_f32``), then the bias (float32 + bf16 is float32); for
    a stacked kernel (E, in, out) the bias is (E, out) and the result (E,
    B, out)."""
    y = dot_f32(x, kernel)
    if bias is None:
        return y
    return y + (bias if bias.ndim == 1 else bias[:, None, :])


class _ColumnProductF32(torch.autograd.Function):
    """``dot_f32(x, kernel)`` of a column shard ``kernel`` (in, out / M)
    under the model axis, whose backward sums x's gradient over the model
    group in float32 and only then rounds it to x's type: the JAX
    transpose of a ``preferred_element_type=float32`` product whose
    contracting dim XLA splits over the model axis (one rounding of the
    float32 sum; a bf16 x rounded on each rank before the sum would differ
    from it by an ulp where the two roundings fall apart).  The kernel's
    gradient is the widened product's, rounded once to its type, as
    ``dot_f32``'s backward gives it."""

    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        ctx.mesh = current()
        return dot_f32(x, kernel)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        gx = gk = None
        if ctx.needs_input_grad[0]:
            gx = sum_over_model(g @ kernel.float().t(), ctx.mesh).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gk = (x.reshape(-1, x.shape[-1]).float().t()
                  @ g.reshape(-1, g.shape[-1])).to(kernel.dtype)
        return gx, gk


def model_affine(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                 features: int) -> torch.Tensor:
    """``affine`` of a layer ``features`` wide whose (in, out) ``kernel``
    may be a column shard under the model axis: the rank's columns of x @
    kernel (x's gradient summed over the model group in float32,
    ``_ColumnProductF32``) all-gathered over the model group, then the
    whole bias (module docstring)."""
    if kernel.ndim != 2 or kernel.shape[-1] == features:
        return affine(x, kernel, bias)
    if current() is None:
        raise ValueError(f"a kernel of {kernel.shape[-1]} columns for a layer "
                         f"{features} wide: a column shard outside a model-axis step")
    y = gather_from_model(_ColumnProductF32.apply(x, kernel), -1)
    return y if bias is None else y + bias


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


class DNN(nn.Module):
    """The generic MLP of the reference's ``rough_rank/layer.py:33-117``
    (``recommendsystem_tpu/nn/mlp.py::DNN``): per layer ``kernel{i}``
    (in, out), glorot-normal, and ``bias{i}`` zeros; ``activation`` after
    every layer but the last, which takes ``output_activation`` where one
    is given; dropout of ``dropout_rate`` after each layer in training,
    drawn from the ``generator`` of the call.  ``l2_reg`` puts an L2
    penalty of ``l2_reg * sum K^2`` on every kernel.  ``stack=E`` stacks E
    such MLPs (flax's ``nn.vmap`` of a DNN): kernels (E, in, out), biases
    (E, out), and (B, in) maps to (E, B, out).  Batch normalization
    (``use_bn``) would need running statistics that no step of the port
    carries, and no model uses it: it raises."""

    def __init__(self, in_features: int, hidden_units: Sequence[int],
                 activation: Any = "relu", l2_reg: float = 0.0,
                 dropout_rate: float = 0.0, use_bn: bool = False,
                 output_activation: Any = None, stack: Optional[int] = None,
                 device=None):
        super().__init__()
        if use_bn:
            raise NotImplementedError("DNN(use_bn=True): batch normalization needs "
                                      "running statistics that the port's steps do "
                                      "not carry; no model uses it")
        self.hidden_units = tuple(hidden_units)
        self.stack = stack
        self.l2_reg = l2_reg
        self.dropout_rate = dropout_rate
        n = len(self.hidden_units)
        self.activations = [resolve_activation(
            output_activation if output_activation is not None and i == n - 1
            else activation) for i in range(n)]
        lead = () if stack is None else (stack,)
        for i, unit in enumerate(self.hidden_units):
            setattr(self, f"kernel{i}", nn.Parameter(
                torch.empty(lead + (in_features, unit), device=device)))
            setattr(self, f"bias{i}", nn.Parameter(
                torch.empty(lead + (unit,), device=device)))
            in_features = unit
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for i in range(len(self.hidden_units)):
            init_kernel(glorot_normal_, getattr(self, f"kernel{i}"), generator)
            with torch.no_grad():
                getattr(self, f"bias{i}").zero_()

    def penalized_kernels(self) -> Dict[str, Tuple[float, float]]:
        if not self.l2_reg:
            return {}
        return {f"kernel{i}": (0.0, self.l2_reg) for i in range(len(self.hidden_units))}

    def model_axis_reads(self) -> Dict[str, str]:
        if self.stack is not None:
            return {}
        return {f"kernel{i}": "column" for i in range(len(self.hidden_units))}

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.after_first(model_affine(x, self.kernel0, self.bias0,
                                             self.hidden_units[0]), training, generator)

    def after_first(self, x: torch.Tensor, training: bool = False,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The MLP from its first layer's ``inputs @ kernel0 + bias0`` on:
        that layer's activation and dropout, then the deeper layers."""
        for i, act in enumerate(self.activations):
            if i:
                x = model_affine(x, getattr(self, f"kernel{i}"), getattr(self, f"bias{i}"),
                                 self.hidden_units[i])
            x = act(x)
            if training and self.dropout_rate > 0:
                keep = self._keep_draw(x, generator)
                x = torch.where(keep >= self.dropout_rate, x / (1.0 - self.dropout_rate),
                                torch.zeros((), device=x.device))
        return x

    def _keep_draw(self, x: torch.Tensor, generator) -> torch.Tensor:
        """The dropout's uniform draws for ``x``; a shard of the experts
        (E/M of a stack of E) takes its rows of the whole stack's draws, so
        the experts drop what they drop on one rank."""
        if self.stack is None or x.shape[0] == self.stack:
            return torch.rand(x.shape, generator=generator, device=x.device)
        whole = torch.rand((self.stack,) + tuple(x.shape[1:]), generator=generator,
                           device=x.device)
        return whole.narrow(0, current().model_rank * x.shape[0], x.shape[0])


def regularized_kernels(module: nn.Module) -> Dict[Tuple[float, float], List[str]]:
    """The kernels that carry an L1L2 penalty in ``module``: {(l1, l2):
    [parameter name of each such kernel]}, in module order; empty when no
    layer carries one.  A layer says which of its kernels carry one through
    ``penalized_kernels()`` ({local name: (l1, l2)}: a Dense with a
    ``kernel_regularizer``, a DNN or CrossNet with ``l2_reg``, stacked or
    not).  The train step builds it once."""
    groups: Dict[Tuple[float, float], List[str]] = {}
    for name, mod in module.named_modules():
        found = getattr(mod, "penalized_kernels", None)
        if found is None:
            continue
        for local, reg in found().items():
            full = f"{name}.{local}" if name else local
            groups.setdefault(tuple(float(r) for r in reg), []).append(full)
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
