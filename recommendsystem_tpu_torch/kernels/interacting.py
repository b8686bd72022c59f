"""One fused InteractingLayer iteration: K6.

Counterpart of ``recommendsystem_tpu/kernels/interacting_pallas.py``.
``interacting_attention`` keeps the JAX signature: x (B, F, D) and a dict
of parameters ``wq``/``wk``/``wv``/``wr`` (D, U) and ``bq``/``bk``/``bv``/
``br``/``gamma``/``beta`` (U,); returns (B, F, U) float32:

    LN(relu(attn(relu(x Wq + bq), relu(x Wk + bk), relu(x Wv + bv))
            + relu(x Wr + br))) * gamma + beta

with ``head_num`` heads cut head-major from U, scores divided by
sqrt(U / head_num) and a LayerNorm over U with ``rsqrt(var + ln_eps)``.  On
a CUDA tensor it launches the hand-written kernel of ``csrc/interacting.cu``;
on a CPU tensor it runs ``interacting_attention_plain``, the same math in
PyTorch ops: the custom op ``interacting_attention`` of ``kernels/_ops.py``,
so an exported program keeps the kernel.  x may be float32 or bfloat16 and
the parameters too (all ten of one type, which may differ from x's), as the
bf16 compute policy gives them: the JAX kernel's body takes every product
with ``preferred_element_type=float32``, so on bf16 operands it is the
float32 body on inputs widened exactly; the kernel widens each value as it
loads it and the output is float32.  Where an input needs a gradient the call goes through
``InteractingAttentionFunction``, whose backward recomputes through the
plain version, as the JAX ``custom_vjp`` recomputes through ``_reference``.
The kernel takes D = U = 8 (the width of every model that builds the
layer) and 1 <= F <= 256 (``kernel_takes``); on a card any other width
raises.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import _ops
from ._build import FLOATS, check, count_launch, library, require, stream_handle

PARAM_NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "wr", "br", "gamma", "beta")
KERNEL_D = 8        # the only input and unit width the kernel is built for
MAX_F = 256         # a block holds one thread per (sample, field), at most 256


def kernel_takes(d: int, u: int, f: int) -> bool:
    """Whether the kernel is built for input width ``d``, ``u`` units and
    ``f`` fields."""
    return d == u == KERNEL_D and 1 <= f <= MAX_F


def interacting_attention_plain(x: torch.Tensor, p: Dict[str, torch.Tensor],
                                head_num: int, ln_eps: float) -> torch.Tensor:
    """``_attention_block`` in PyTorch ops, on (B, F, D).  Each product
    widens its operands to float32 (exact for bf16, as JAX's
    ``preferred_element_type=float32`` dot), and float32 + bf16 promotes, so
    the math is float32 and a bf16 input's gradient is rounded to bf16 once
    a use, as the JAX ``custom_vjp`` gives it."""
    b, f, d = x.shape
    u = p["wq"].shape[1]
    dh = u // head_num
    flat = x.reshape(b * f, d)

    def proj(w, bias):
        return torch.relu(flat.float() @ p[w].float() + p[bias]).reshape(b, f, u)

    q, k, v = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
    outs = []
    for h in range(head_num):
        sl = slice(h * dh, (h + 1) * dh)
        w = (q[:, :, sl] @ k[:, :, sl].transpose(1, 2)) / (dh ** 0.5)
        outs.append(torch.softmax(w, dim=-1) @ v[:, :, sl])       # (B, F, dh)
    o = outs[0] if head_num == 1 else torch.cat(outs, dim=-1)
    o = torch.relu(o + proj("wr", "br"))
    mu = o.mean(dim=-1, keepdim=True)
    var = (o - mu).square().mean(dim=-1, keepdim=True)
    return (o - mu) * torch.rsqrt(var + ln_eps) * p["gamma"] + p["beta"]


def _check(x, p, head_num: int) -> None:
    require(x, "x", FLOATS)
    if x.ndim != 3:
        raise ValueError(f"interacting_attention: x must be (B, F, D), got "
                         f"{tuple(x.shape)}")
    if set(p) != set(PARAM_NAMES):
        raise ValueError(f"interacting_attention: params {sorted(p)}, expected "
                         f"{sorted(PARAM_NAMES)}")
    b, f, d = x.shape
    u = p["wq"].shape[-1] if p["wq"].ndim == 2 else -1
    ptype = getattr(p["wq"], "dtype", None)
    ptypes = (ptype,) if ptype in FLOATS else FLOATS      # all ten of wq's type
    for name in PARAM_NAMES:
        shape = (d, u) if name.startswith("w") else (u,)
        require(p[name], name, ptypes, shape, x.device)
    if head_num < 1 or u % head_num:
        raise ValueError(f"interacting_attention: {head_num} heads do not "
                         f"divide {u} units")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"interacting_attention: no kernel for device {x.device}")
    if x.device.type == "cuda" and not kernel_takes(d, u, f):
        raise ValueError(f"interacting_attention: the kernel takes D = U = "
                         f"{KERNEL_D} and 1 <= F <= {MAX_F}; got D {d}, U {u}, F {f}")


def interacting_launch(x, p, head_num: int, ln_eps: float) -> torch.Tensor:
    """K6's launcher, the CUDA implementation of the op
    ``recommendsystem_tpu_torch::interacting_attention``: raises unless x
    is 16-byte aligned."""
    if x.data_ptr() % 16:
        raise ValueError("interacting_attention: x must be 16-byte aligned "
                         "(the kernel reads a row in 16-byte loads)")
    b, f, _ = x.shape
    u = p["wq"].shape[1]
    out = torch.empty((b, f, u), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = library("interacting")
    with torch.cuda.device(x.device):
        code = lib.interacting_attention(
            x.data_ptr(), *(p[n].data_ptr() for n in PARAM_NAMES), out.data_ptr(),
            b, f, head_num, (u // head_num) ** 0.5, ln_eps,
            int(x.dtype == torch.bfloat16), int(p["wq"].dtype == torch.bfloat16),
            stream_handle(x.device))
    check(lib, code, "interacting_attention")
    count_launch("interacting_attention")
    return out


def _forward(x, p, head_num: int, ln_eps: float) -> torch.Tensor:
    """The op ``interacting_attention``: the kernel on a card,
    ``interacting_attention_plain`` on the CPU."""
    return _ops.op("interacting_attention")(x, *(p[n] for n in PARAM_NAMES),
                                            head_num, float(ln_eps))


class InteractingAttentionFunction(torch.autograd.Function):
    """K6 forward; the backward recomputes through
    ``interacting_attention_plain``.  Takes x and the ten parameters in
    ``PARAM_NAMES`` order, then ``head_num`` and ``ln_eps``."""

    @staticmethod
    def forward(ctx, x, *args):
        tensors, (head_num, ln_eps) = args[:-2], args[-2:]
        ctx.save_for_backward(x, *tensors)
        ctx.head_num, ctx.ln_eps = head_num, ln_eps
        with torch.no_grad():
            return _forward(x, dict(zip(PARAM_NAMES, tensors)), head_num, ln_eps)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = interacting_attention_plain(
                inputs[0], dict(zip(PARAM_NAMES, inputs[1:])), ctx.head_num,
                ctx.ln_eps)
        grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad], g))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None)


def interacting_attention(x: torch.Tensor, params: Dict[str, torch.Tensor],
                          head_num: int = 2, ln_eps: float = 1e-3) -> torch.Tensor:
    """K6: one fused InteractingLayer iteration, (B, F, D) -> (B, F, U)
    float32, differentiable in x and every parameter; x float32 or bf16,
    the ten parameters float32 or bf16 (all of one type)."""
    _check(x, params, head_num)
    tensors = [params[n] for n in PARAM_NAMES]
    if torch.is_grad_enabled() and any(t.requires_grad for t in [x] + tensors):
        return InteractingAttentionFunction.apply(x, *tensors, head_num, ln_eps)
    return _forward(x, params, head_num, ln_eps)
