"""DIN attention pooling of the staytime model: K7.

Counterpart of ``recommendsystem_tpu/kernels/din_pallas.py``.  ``din_pool``
keeps the JAX signature: query (B, H), facts (B, T, H), mask (B, T) float
{0, 1}, scorer weights w1 (4H, 16), b1 (16,), w2 (16, 1), b2 (1,); returns
(B, H) float32.  On a CUDA tensor it launches the hand-written kernel of
``csrc/din_pool.cu``; on a CPU tensor it runs ``din_pool_plain``, the same
math in PyTorch ops; both entries are the custom ops ``din_pool`` and
``din_pool_gather`` of ``kernels/_ops.py``, so an exported program keeps
the kernel.  Where an input needs a gradient the call goes through
``DinPoolFunction``, whose backward recomputes through the plain version, as
the JAX ``custom_vjp`` recomputes through ``_din_block``; the mask gets no
gradient.

Under the bf16 compute policy the query, the facts and the scorer are
bfloat16 (all of one type; the mask stays float32), and the pool keeps the
JAX kernel's dtypes (``_din_block`` on bf16 inputs): the features ``q - f``
and ``q * f`` are bf16, each rounded, the scorer's first product
accumulates them in float32, and the sigmoid, the second product, the
softmax and the weighted sum are float32, as is the output.  The gathering
entry rounds each fact read from a float32 table to bf16 (the JAX predict
step casts its folded facts); a bf16 table's are bf16 already.  The kernel takes H = 16 and a scorer of width 16, the staytime
model's; on a card any other width raises.

The query, the facts and the mask may be strided views (the staytime model
passes the first 16 lanes of 32-lane rows): the kernel takes their row
strides; their last dimension must be contiguous.

``din_pool_gather`` is the same pool over facts it gathers itself from an
embedding table of float32 or bfloat16 rows (widened to float32 as they
are read): the lanes ``lanes`` of ``mask * table[ids]``, what the
fold K2 writes and the model slices, without K2's rows in device memory,
in ``facts_dtype``.  Its plain version is exactly that:
``fold_rows_plain``, the slice, the cast, then ``din_pool_plain``.  It has no gradient: the predict step takes it (the
staytime model's sequence columns come as ``embedding.packed.SequenceRows``
handles there), the train step keeps ``din_pool``.
"""

from __future__ import annotations

import torch

from ..embedding import packed as _packed
from . import _ops
from ._build import FLOATS, check, count_launch, library, require, stream_handle

MASK_PAD = -(2.0 ** 32) + 1.0
HIDDEN = 16         # the scorer's width
KERNEL_H = 16       # the only query width the kernel is built for: staytime's
MAX_T = 512         # the kernel keeps T * 8 scores and per-sample folds under 48 KB


def din_pool_plain(query, facts, mask, w1, b1, w2, b2) -> torch.Tensor:
    """``_din_block`` in PyTorch ops, in its dtypes: features [q, f, q - f,
    q * f] in the inputs' type (bf16 rounds q - f and q * f), the scorer
    sigmoid(. W1 + b1) . W2 + b2 with products widened to float32 (JAX's
    ``preferred_element_type=float32``), ``MASK_PAD`` where the mask is not
    > 0, softmax over T, and the score-weighted sum of the facts, all in
    float32.  Its autograd rounds a bf16 input's gradient as JAX's
    ``vjp`` of the block does, and is the training backward of K7."""
    b, t, h = facts.shape
    q = query[:, None, :].expand(b, t, h)
    feats = torch.cat([q, facts, q - facts, q * facts], dim=-1)
    s = torch.sigmoid(feats.reshape(b * t, 4 * h).float() @ w1.float() + b1)
    scores = (s @ w2.float() + b2).reshape(b, t)
    scores = torch.where(mask > 0, scores, torch.full_like(scores, MASK_PAD))
    scores = torch.softmax(scores, dim=-1)
    return (scores[:, :, None] * facts).sum(dim=1)


def _check_pool(what, query, mask, w1, b1, w2, b2, b, t, h, dev, dtype) -> None:
    """What both entries check: query (B, H) of ``dtype`` (float32 or bf16:
    the compute type) and mask (B, T) float32 on the facts' device,
    contiguous in their last dim; the scorer's shapes, in ``dtype``; on a
    card the widths the kernels take."""
    if dtype not in FLOATS:
        raise TypeError(f"{what}: facts of {dtype}, expected float32 or bfloat16")
    for name, x, want in (("query", query, dtype), ("mask", mask, torch.float32)):
        if not isinstance(x, torch.Tensor) or x.dtype != want or x.ndim != 2:
            raise TypeError(f"{what}: {name} must be a 2-d {want} tensor, got "
                            f"{getattr(x, 'dtype', type(x).__name__)}")
    if tuple(query.shape) != (b, h) or tuple(mask.shape) != (b, t):
        raise ValueError(f"{what}: query {tuple(query.shape)} and mask "
                         f"{tuple(mask.shape)} do not fit facts {(b, t, h)}")
    hid = w1.shape[-1] if w1.ndim == 2 else -1
    for name, x, shape in (("w1", w1, (4 * h, hid)), ("b1", b1, (hid,)),
                           ("w2", w2, (hid, 1)), ("b2", b2, (1,))):
        require(x, name, dtype, shape, dev)
    if query.device != dev or mask.device != dev:
        raise ValueError(f"{what}: inputs on more than one device")
    for name, x in (("query", query), ("mask", mask)):
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be contiguous in its last dim")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {dev}")
    if dev.type == "cuda" and (h != KERNEL_H or hid != HIDDEN or t > MAX_T):
        raise ValueError(f"{what}: the kernel takes H {KERNEL_H}, a scorer of "
                         f"width {HIDDEN} and T <= {MAX_T}; got H {h}, width "
                         f"{hid}, T {t}")


def _check(query, facts, mask, w1, b1, w2, b2) -> None:
    if not isinstance(facts, torch.Tensor) or facts.dtype not in FLOATS or facts.ndim != 3:
        raise TypeError("din_pool: facts must be a 3-d float32 or bfloat16 tensor")
    if facts.shape[-1] > 1 and facts.stride(-1) != 1:
        raise ValueError("din_pool: facts must be contiguous in its last dim")
    _check_pool("din_pool", query, mask, w1, b1, w2, b2, *facts.shape, facts.device,
                facts.dtype)


def din_pool_launch(query, facts, mask, w1, b1, w2, b2) -> torch.Tensor:
    """K7's launcher with the facts given, the CUDA implementation of the
    op ``recommendsystem_tpu_torch::din_pool``."""
    b, t, h = facts.shape
    out = torch.empty((b, h), dtype=torch.float32, device=facts.device)
    if out.numel() == 0:
        return out
    lib = library("din_pool")
    with torch.cuda.device(facts.device):
        code = lib.din_pool(
            query.data_ptr(), facts.data_ptr(), mask.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), b, t,
            query.stride(0), facts.stride(0), facts.stride(1), mask.stride(0),
            mask.stride(1), int(facts.dtype == torch.bfloat16),
            stream_handle(facts.device))
    check(lib, code, "din_pool")
    count_launch("din_pool")
    return out


def _forward(query, facts, mask, w1, b1, w2, b2) -> torch.Tensor:
    """The op ``din_pool``: the kernel on a card, ``din_pool_plain`` on the
    CPU."""
    return _ops.op("din_pool")(query, facts, mask, w1, b1, w2, b2)


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
    ``mask`` (B, T) float32 {0, 1}, with the scorer w1 (4H, 16), b1 (16,),
    w2 (16, 1), b2 (1,); the query, the facts and the scorer all float32 or
    all bfloat16.  Returns (B, H) float32, differentiable in every input
    but the mask (gradients in the inputs' types)."""
    _check(query, facts, mask, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (query, facts, w1, b1, w2, b2)):
        return DinPoolFunction.apply(query, facts, mask, w1, b1, w2, b2)
    return _forward(query, facts, mask, w1, b1, w2, b2)


def din_pool_gather_plain(query, table, ids, mask, lanes, w1, b1, w2, b2,
                          facts_dtype=torch.float32) -> torch.Tensor:
    """``din_pool_plain`` over the facts ``fold_rows_plain(table, ids,
    mask)[:, lo:hi]`` of the (B, T) ``ids`` and ``mask``, cast to
    ``facts_dtype``."""
    b, t = ids.shape
    lo, hi = lanes
    facts = _packed.fold_rows_plain(table, ids.reshape(-1), mask.reshape(-1))[:, lo:hi]
    return din_pool_plain(query, facts.reshape(b, t, hi - lo).to(facts_dtype), mask,
                          w1, b1, w2, b2)


def _check_gather(query, table, ids, mask, lanes, w1, b1, w2, b2, facts_dtype) -> None:
    require(table, "din_pool_gather: table", (torch.float32, torch.bfloat16))
    if table.ndim != 2:
        raise ValueError(f"din_pool_gather: table must be (rows, D), got "
                         f"{tuple(table.shape)}")
    dev = table.device
    require(ids, "din_pool_gather: ids", torch.int32)
    if ids.ndim != 2 or ids.device != dev:
        raise ValueError(f"din_pool_gather: ids must be (B, T) on {dev}, got "
                         f"{tuple(ids.shape)} on {ids.device}")
    require(mask, "din_pool_gather: mask", torch.float32, ids.shape)
    b, t = ids.shape
    h = query.shape[-1]
    lo, hi = lanes
    # the kernel reads a fact as 16-byte chunks of its table row (the
    # launcher checks the table's alignment)
    if table.shape[1] % 4 or lo % 4 or not (
            0 <= lo and hi - lo == h and hi <= table.shape[1]):
        raise ValueError(f"din_pool_gather: lanes [{lo}, {hi}) of a table of D "
                         f"{table.shape[1]}: needs D % 4 == 0 and a window of the "
                         f"query's width {h} starting at a multiple of 4")
    _check_pool("din_pool_gather", query, mask, w1, b1, w2, b2, b, t, h, dev, facts_dtype)


def din_pool_gather(query: torch.Tensor, table: torch.Tensor, ids: torch.Tensor,
                    mask: torch.Tensor, lanes, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor,
                    facts_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K7 over gathered facts: ``din_pool(query, facts, mask, ...)`` with
    ``facts = (mask[..., None] * table[ids])[:, :, lo:hi]`` for ``lanes =
    (lo, hi)``, cast to ``facts_dtype`` (float32, or bfloat16 under the
    bf16 compute policy: then the query and the scorer are bf16 too).
    ``table`` (rows, D) float32 or bfloat16 (its lanes widened to float32
    as they are read), 16-byte aligned, D % 4 == 0;
    ``ids`` (B, T) int32 and ``mask`` (B, T) float32 {0, 1}, contiguous; a
    window of the query's width starting at a multiple of 4; ``query`` (B,
    H) may be a strided view.  A masked entry's fact is 0 and its table row
    is not read.  Returns (B, H) float32, with no gradient: raises
    ``RuntimeError`` where an input needs one."""
    _check_gather(query, table, ids, mask, lanes, w1, b1, w2, b2, facts_dtype)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (query, table, w1, b1, w2, b2)):
        raise RuntimeError("din_pool_gather has no gradient: train through din_pool "
                           "on gathered facts")
    return _ops.op("din_pool_gather")(query, table, ids, mask, int(lanes[0]),
                                      int(lanes[1]), w1, b1, w2, b2, facts_dtype)


def din_pool_gather_launch(query, table, ids, mask, lanes, w1, b1, w2, b2,
                           facts_dtype) -> torch.Tensor:
    """K7's gathering launcher, the CUDA implementation of the op
    ``recommendsystem_tpu_torch::din_pool_gather``: raises unless the table
    is 16-byte aligned."""
    if table.data_ptr() % 16:
        raise ValueError(f"din_pool_gather: the table must be 16-byte aligned (the "
                         f"kernel reads 16-byte chunks); it is {table.data_ptr() % 16} "
                         f"bytes past")
    b, t = ids.shape
    out = torch.empty((b, query.shape[1]), dtype=torch.float32, device=table.device)
    if out.numel() == 0 or t == 0:
        return out.zero_()
    lib = library("din_pool")
    with torch.cuda.device(table.device):
        code = lib.din_pool_gather(
            query.data_ptr(), table.data_ptr(), ids.data_ptr(), mask.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            b, t, query.stride(0), table.shape[1], lanes[0],
            int(table.dtype == torch.bfloat16), int(facts_dtype == torch.bfloat16),
            stream_handle(table.device))
    check(lib, code, "din_pool_gather")
    count_launch("din_pool")
    return out
