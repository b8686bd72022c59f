"""DIN attention pooling of the staytime model: K7.

Counterpart of ``recommendsystem_tpu/kernels/din_pallas.py``.  ``din_pool``
keeps the JAX signature: query (B, H), facts (B, T, H), mask (B, T) float
{0, 1}, scorer weights w1 (4H, 16), b1 (16,), w2 (16, 1), b2 (1,); returns
(B, H) float32.  On a CUDA tensor it launches the hand-written kernel of
``csrc/din_pool.cu``; on a CPU tensor it runs ``din_pool_plain``, the same
math in PyTorch ops.  Where an input needs a gradient the call goes through
``DinPoolFunction``, whose backward recomputes through the plain version, as
the JAX ``custom_vjp`` recomputes through ``_din_block``; the mask gets no
gradient.  The kernel takes H = 16 and a scorer of width 16, the staytime
model's; on a card any other width raises.

The query, the facts and the mask may be strided views (the staytime model
passes the first 16 lanes of 32-lane rows): the kernel takes their row
strides; their last dimension must be contiguous.
"""

from __future__ import annotations

import torch

from ._build import check, count_launch, library, require, stream_handle

MASK_PAD = -(2.0 ** 32) + 1.0
HIDDEN = 16         # the scorer's width
KERNEL_H = 16       # the only query width the kernel is built for: staytime's
MAX_T = 512         # the kernel keeps T * 8 scores and per-sample folds under 48 KB


def din_pool_plain(query, facts, mask, w1, b1, w2, b2) -> torch.Tensor:
    """``_din_block`` in PyTorch ops: features [q, f, q - f, q * f], the
    scorer sigmoid(. W1 + b1) . W2 + b2, ``MASK_PAD`` where the mask is not
    > 0, softmax over T, and the score-weighted sum of the facts."""
    b, t, h = facts.shape
    q = query[:, None, :].expand(b, t, h)
    feats = torch.cat([q, facts, q - facts, q * facts], dim=-1)
    s = torch.sigmoid(feats.reshape(b * t, 4 * h) @ w1 + b1)
    scores = (s @ w2 + b2).reshape(b, t)
    scores = torch.where(mask > 0, scores, torch.full_like(scores, MASK_PAD))
    scores = torch.softmax(scores, dim=-1)
    return (scores[:, :, None] * facts).sum(dim=1)


def _check(query, facts, mask, w1, b1, w2, b2) -> None:
    for name, x, ndim in (("query", query, 2), ("facts", facts, 3), ("mask", mask, 2)):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 or x.ndim != ndim:
            raise TypeError(f"din_pool: {name} must be a {ndim}-d float32 tensor")
    b, t, h = facts.shape
    dev = facts.device
    if tuple(query.shape) != (b, h) or tuple(mask.shape) != (b, t):
        raise ValueError(f"din_pool: query {tuple(query.shape)} and mask "
                         f"{tuple(mask.shape)} do not fit facts {(b, t, h)}")
    hid = w1.shape[-1] if w1.ndim == 2 else -1
    for name, x, shape in (("w1", w1, (4 * h, hid)), ("b1", b1, (hid,)),
                           ("w2", w2, (hid, 1)), ("b2", b2, (1,))):
        require(x, name, torch.float32, shape, dev)
    if query.device != dev or mask.device != dev:
        raise ValueError("din_pool: inputs on more than one device")
    for name, x in (("query", query), ("facts", facts), ("mask", mask)):
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError(f"din_pool: {name} must be contiguous in its last dim")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"din_pool: no kernel for device {dev}")
    if dev.type == "cuda" and (h != KERNEL_H or hid != HIDDEN or t > MAX_T):
        raise ValueError(f"din_pool: the kernel takes H {KERNEL_H}, a scorer of "
                         f"width {HIDDEN} and T <= {MAX_T}; got H {h}, width "
                         f"{hid}, T {t}")


def _launch(query, facts, mask, w1, b1, w2, b2) -> torch.Tensor:
    b, t, h = facts.shape
    out = torch.empty((b, h), dtype=torch.float32, device=facts.device)
    if out.numel() == 0:
        return out
    lib = library("din_pool")
    with torch.cuda.device(facts.device):
        code = lib.din_pool_f32(
            query.data_ptr(), facts.data_ptr(), mask.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), b, t,
            query.stride(0), facts.stride(0), facts.stride(1), mask.stride(0),
            mask.stride(1), stream_handle(facts.device))
    check(lib, code, "din_pool")
    count_launch("din_pool")
    return out


def _forward(query, facts, mask, w1, b1, w2, b2) -> torch.Tensor:
    if facts.device.type == "cpu":
        return din_pool_plain(query, facts, mask, w1, b1, w2, b2)
    return _launch(query, facts, mask, w1, b1, w2, b2)


class DinPoolFunction(torch.autograd.Function):
    """K7 forward; the backward recomputes through ``din_pool_plain``."""

    @staticmethod
    def forward(ctx, query, facts, mask, w1, b1, w2, b2):
        ctx.save_for_backward(query, facts, mask, w1, b1, w2, b2)
        with torch.no_grad():
            return _forward(query, facts, mask, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        query, facts, mask, w1, b1, w2, b2 = ctx.saved_tensors
        # the mask gets no gradient
        inputs = [x.detach().requires_grad_(need and i != 2) for i, (x, need) in
                  enumerate(zip((query, facts, mask, w1, b1, w2, b2),
                                ctx.needs_input_grad))]
        with torch.enable_grad():
            out = din_pool_plain(*inputs)
        grads = iter(torch.autograd.grad(out, [x for x in inputs if x.requires_grad], g))
        return tuple(next(grads) if x.requires_grad else None for x in inputs)


def din_pool(query: torch.Tensor, facts: torch.Tensor, mask: torch.Tensor,
             w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor) -> torch.Tensor:
    """K7: DIN pooling of ``facts`` (B, T, H) by ``query`` (B, H) under
    ``mask`` (B, T) float {0, 1}, with the scorer w1 (4H, 16), b1 (16,),
    w2 (16, 1), b2 (1,).  Returns (B, H) float32, differentiable in every
    input but the mask."""
    _check(query, facts, mask, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (query, facts, w1, b1, w2, b2)):
        return DinPoolFunction.apply(query, facts, mask, w1, b1, w2, b2)
    return _forward(query, facts, mask, w1, b1, w2, b2)
