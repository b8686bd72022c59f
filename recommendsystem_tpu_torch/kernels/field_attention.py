"""Field attention for the InteractingLayer: K5 forward (K5f) and backward
(K5b), with dropout on the attention weights.

Counterpart of ``recommendsystem_tpu/kernels/field_attention_pallas.py``.
``field_attention`` keeps the JAX public layout: q/k/v of shape
``(head, d_head, F, B)``, batch-minor, float32 or bfloat16 (all three of
one type: the bf16 compute policy's first InteractingLayer iteration gives
bf16 ones).  The output o and the log-sum-exp are float32 whatever the
inputs, and every sum is float32: a bf16 input is widened exactly as it
is read.  The backward gives dq, dk and dv in q's type, computed in float32
and rounded once, as a JAX custom VJP gives the cotangents of bf16
primals.  (The JAX K5 itself refuses bf16 inputs: its float32 scratch
takes no bf16 store.  Its float32 body on the widened values is what the
port computes.)  On a CUDA tensor it launches
the hand-written kernels of ``csrc/field_attention.cu``; on a CPU tensor it
runs their plain versions.  The forward is the custom op
``field_attention_fwd`` of ``kernels/_ops.py``, so an exported program
keeps K5f.  Where an input needs a gradient the call goes
through ``FieldAttentionFunction``, whose forward also keeps the log-sum-exp
of each softmax row and whose backward is K5b (``field_attention_bwd``).

Dropout at ``rate > 0`` draws, for every weight (head, query fq, key fk,
sample b), word ``fk % 4`` of Philox4x32-10 at counter ``(sample0 + b, fq,
head, fk // 4)`` (mod 2**32) under the key ``(seed >> 32, seed &
0xffffffff)``; the weight is kept when the word is >= ``rate * 2**32`` and
scaled by ``1 / (1 - rate)``.  ``philox4x32_10`` computes the same bits with
torch integer ops, so the kernels and their plain versions apply the same
mask.  ``sample0`` is the global index of the call's first sample: 0 for a
whole batch, ``rank * B / n`` for a rank's rows of a batch in the sharded
mode, so that every sample draws the mask it draws in the whole batch.  A
call that does not pass it takes ``sample_offset``'s (0 outside one), which
the sharded train step sets around its tower.

The kernels read the key from device memory, not from their launch
parameters: one int64 word holding ``_key(seed)`` as ``k0 << 32 | k1``
(``dropout_key``, written by one fill with no copy from the host), so that
a launch captured in a CUDA graph draws the key its replay finds there.
``seed`` is a Python int, or such a key tensor (``is_key``): a captured
train step passes its key buffer, which it rewrites before each replay
(``write_key``), and ``iteration_key`` derives an InteractingLayer
iteration's key from it on the device.  Given an int, a card call makes
the key itself; a CPU call reads a key tensor's int.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch

from . import _ops
from ._build import FLOATS, check, count_launch, library, require, stream_handle

SUPPORTED_D_HEAD = (1, 2, 4, 8, 16, 32)
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
# plain versions materialise (head, Fq, F, B) tensors: query fields are
# taken in chunks of at most this many weights
_PLAIN_CHUNK = 1 << 25
_SAMPLE0 = contextvars.ContextVar("field_attention_sample0", default=0)


@contextlib.contextmanager
def sample_offset(sample0: int):
    """Within the block, a field attention call that does not pass its
    ``sample0`` numbers its samples from ``sample0`` in the dropout
    counter (the sharded step: the rank's first global sample)."""
    if not 0 <= sample0 < 1 << 32:
        raise ValueError(f"sample0 {sample0} not in [0, 2**32)")
    token = _SAMPLE0.set(sample0)
    try:
        yield
    finally:
        _SAMPLE0.reset(token)


# ---------------------------------------------------------------------------
# dropout bits
# ---------------------------------------------------------------------------

def _mulhilo(a: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of ``a * x`` for a 32-bit constant ``a`` and
    int64 ``x`` in [0, 2**32), without overflowing int64."""
    xl, xh = x & 0xFFFF, x >> 16
    pl, ph = a * xl, a * xh                       # each < 2**48
    mid = pl + ((ph & 0xFFFF) << 16)
    return (ph >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding 32-bit
    counter words (broadcast together); returns the four output words."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} not in [0, 1)")


def _threshold(rate: float) -> int:
    return min(int(rate * (1 << 32)), _MASK32)


def _key(seed: int) -> Tuple[int, int]:
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} not in [0, 2**64)")
    return seed >> 32, seed & _MASK32


def dropout_key(seed: int, device) -> torch.Tensor:
    """The key of ``seed`` (below 2**64) as the kernels read it: a (1,)
    int64 tensor on ``device`` holding ``k0 << 32 | k1`` of ``_key(seed)``,
    made by one fill (no copy from the host)."""
    _key(seed)
    return torch.full((1,), _ops.signed_seed(seed), dtype=torch.int64, device=device)


def write_key(key: torch.Tensor, seed: int) -> None:
    """Overwrite a key tensor with ``seed``'s key, in stream order (one
    fill, whose value rides in its launch: no host buffer to race)."""
    _key(seed)
    key.fill_(_ops.signed_seed(seed))


def is_key(seed) -> bool:
    """Whether ``seed`` is a key tensor (else a Python int)."""
    return isinstance(seed, torch.Tensor)


def key_seed(key: torch.Tensor) -> int:
    """The seed a key tensor holds, in [0, 2**64) (a host read)."""
    return int(key.item()) % (1 << 64)


def iteration_key(key: torch.Tensor, i: int) -> torch.Tensor:
    """The key of seed ``(s << 32) | i`` from the key of a seed ``s`` below
    2**32, on the key's device: the InteractingLayer's seed of iteration
    ``i`` (the shift wraps the int64 word as the unsigned one)."""
    return torch.bitwise_or(torch.bitwise_left_shift(key, 32), i)


def _check_seed(seed, device) -> None:
    """A seed an entry takes: an int below 2**64, or a key tensor on the
    call's device."""
    if not is_key(seed):
        _key(seed)
        return
    if seed.dtype != torch.int64 or tuple(seed.shape) != (1,):
        raise ValueError(f"dropout key: expected a (1,) int64 tensor, got "
                         f"{tuple(seed.shape)} {seed.dtype}")
    if seed.device != device:
        raise ValueError(f"dropout key on {seed.device}, expected {device}")


def _card_key(seed, device, rate: float) -> Optional[torch.Tensor]:
    """The key tensor a card launch reads: ``seed``'s own, or one made from
    an int; None without dropout (the kernel reads no key)."""
    if rate <= 0.0:
        return None
    return seed if is_key(seed) else dropout_key(seed, device)


def _int_seed(seed) -> int:
    return key_seed(seed) if is_key(seed) else seed


def dropout_scale(h: int, f: int, b: int, seed: int, rate: float, device,
                  fq0: int = 0, nq: Optional[int] = None,
                  sample0: int = 0) -> torch.Tensor:
    """(h, nq, F, B) float32 multipliers of the attention weights of query
    fields ``fq0 .. fq0+nq`` of samples ``sample0 .. sample0+B``: ``1 / (1 -
    rate)`` where kept, 0 where dropped."""
    nq = f - fq0 if nq is None else nq
    k0, k1 = _key(seed)
    i64 = dict(dtype=torch.int64, device=device)
    groups = -(-f // 4)
    words = philox4x32_10((torch.arange(sample0, sample0 + b, **i64) & _MASK32).view(1, 1, 1, b),
                          torch.arange(fq0, fq0 + nq, **i64).view(1, nq, 1, 1),
                          torch.arange(h, **i64).view(h, 1, 1, 1),
                          torch.arange(groups, **i64).view(1, 1, groups, 1),
                          k0, k1)
    bits = torch.stack(words, dim=3).reshape(h, nq, 4 * groups, b)[:, :, :f]
    keep = bits >= _threshold(rate)
    return keep.to(torch.float32) * torch.tensor(1.0 / (1.0 - rate),
                                                 dtype=torch.float32)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _wide(x: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor widened to float32 (exact); any other as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _chunks(h: int, f: int, b: int):
    step = max(1, min(f, _PLAIN_CHUNK // max(1, h * f * b)))
    return range(0, f, step), step


def _scores(q, k, f0, f1):
    dh = q.shape[1]
    return torch.einsum("hdfb,hdgb->hfgb", q[:, :, f0:f1], k) / (dh ** 0.5)


def field_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, seed: int = 0,
                              rate: float = 0.0, sample0: int = 0) -> torch.Tensor:
    """Plain forward, differentiable by autograd: softmax over keys of
    q.k / sqrt(dh), times the dropout multipliers, times v, with every
    (head, F, F, B) weight materialised; bf16 q, k, v widened to float32
    first (their gradients rounded back to bf16), a float32 result."""
    _check_rate(rate)
    q, k, v = _wide(q), _wide(k), _wide(v)
    h, _, f, b = q.shape
    outs = []
    starts, step = _chunks(h, f, b)
    for f0 in starts:
        f1 = min(f, f0 + step)
        p = torch.softmax(_scores(q, k, f0, f1), dim=2)
        if rate > 0.0:
            p = p * dropout_scale(h, f, b, seed, rate, q.device, f0, f1 - f0, sample0)
        outs.append(torch.einsum("hfgb,hdgb->hdfb", p, v))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def field_attention_fwd_plain(q, k, v, seed: int = 0, rate: float = 0.0,
                              sample0: int = 0):
    """Plain forward that also returns the (h, F, B) log-sum-exp of each
    softmax row, as the forward kernel writes it for the backward (both
    float32)."""
    with torch.no_grad():
        o = field_attention_reference(q, k, v, seed, rate, sample0)
        q, k = _wide(q), _wide(k)
        h, _, f, b = q.shape
        starts, step = _chunks(h, f, b)
        lse = torch.cat([torch.logsumexp(_scores(q, k, f0, min(f, f0 + step)), dim=2)
                         for f0 in starts], dim=1)
    return o.contiguous(), lse


def field_attention_bwd_reference(q, k, v, o, lse, do, seed: int = 0,
                                  rate: float = 0.0, sample0: int = 0):
    """Plain backward by the formulas of the JAX kernel's ``_bwd_kernel``
    (``field_attention_pallas.py:126-145``): p = exp(s - lse), the dropout
    multipliers m regenerated from the seed, dv = sum_q p m do,
    dp = m (do . v), ds = p (dp - rowsum(do * o)), dq = scale ds k,
    dk = scale ds^T q, in float32 (bf16 q, k, v widened).  Returns (dq, dk,
    dv) in q's type (bf16 ones rounded once)."""
    _check_rate(rate)
    dtype = q.dtype
    q, k, v = _wide(q), _wide(k), _wide(v)
    h, dh, f, b = q.shape
    scale = 1.0 / dh ** 0.5
    rowdot = (do * o).sum(dim=1)                                # (h, F, B)
    dq = torch.empty_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    starts, step = _chunks(h, f, b)
    for f0 in starts:
        f1 = min(f, f0 + step)
        p = torch.exp(_scores(q, k, f0, f1) - lse[:, f0:f1, None, :])
        dp = torch.einsum("hdfb,hdgb->hfgb", do[:, :, f0:f1], v)
        pd = p
        if rate > 0.0:
            m = dropout_scale(h, f, b, seed, rate, q.device, f0, f1 - f0, sample0)
            pd, dp = p * m, dp * m
        ds = p * (dp - rowdot[:, f0:f1, None, :])
        dv += torch.einsum("hfgb,hdfb->hdgb", pd, do[:, :, f0:f1])
        dq[:, :, f0:f1] = torch.einsum("hfgb,hdgb->hdfb", ds, k) * scale
        dk += torch.einsum("hfgb,hdfb->hdgb", ds, q[:, :, f0:f1]) * scale
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_qkv(q, k, v) -> None:
    require(q, "q", FLOATS)
    if q.ndim != 4:
        raise ValueError(f"q: expected (head, d_head, F, B), got {tuple(q.shape)}")
    require(k, "k", q.dtype, q.shape, q.device)
    require(v, "v", q.dtype, q.shape, q.device)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"field_attention: no kernel for device {q.device}")
    if q.device.type == "cuda" and q.shape[1] not in SUPPORTED_D_HEAD:
        raise ValueError(f"field_attention: d_head {q.shape[1]} not in "
                         f"{SUPPORTED_D_HEAD}")


def bwd_keys_per_chunk(dh: int) -> int:
    """Keys a chunk of K5b (``BwdTile::KC`` of ``csrc/field_attention.cu``):
    where F is larger, dq is summed over several chunks."""
    return min(32, 128 // dh)


def _dropout_args(key: Optional[torch.Tensor], rate: float, sample0: int):
    return (int(rate > 0.0), None if key is None else key.data_ptr(), _threshold(rate),
            1.0 / (1.0 - rate), sample0 & _MASK32)


def _fwd(q, k, v, seed, rate: float, want_lse: bool, sample0: int = 0):
    """K5f: (o, lse or None).  An int seed goes through the op
    ``field_attention_fwd``; a key tensor straight to the launcher on a
    card (the op's schema takes an int)."""
    if is_key(seed) and q.device.type == "cuda":
        o, lse = fwd_launch(q, k, v, _card_key(seed, q.device, rate), rate, want_lse, sample0)
        return o, (lse if want_lse else None)
    o, lse = _ops.op("field_attention_fwd")(q, k, v, _ops.signed_seed(_int_seed(seed)),
                                            float(rate), want_lse, sample0)
    return o, (lse if want_lse else None)


def fwd_launch(q, k, v, key: Optional[torch.Tensor], rate: float, want_lse: bool,
               sample0: int = 0):
    """K5f's launcher (the CUDA implementation of the op
    ``recommendsystem_tpu_torch::field_attention_fwd`` makes its key):
    (o, lse), lse empty unless ``want_lse``; ``key`` is the dropout's key
    tensor (``dropout_key``), None at rate 0."""
    h, dh, f, b = q.shape
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((h, f, b) if want_lse else (0,), dtype=torch.float32,
                      device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = library("field_attention")
    with torch.cuda.device(q.device):
        code = lib.field_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if want_lse else None, h, dh, f, b,
            1.0 / dh ** 0.5, *_dropout_args(key, rate, sample0),
            int(q.dtype == torch.bfloat16), stream_handle(q.device))
    check(lib, code, "field_attention")
    count_launch("field_attention")
    return o, lse


def field_attention_bwd(q, k, v, o, lse, do, seed=0, rate: float = 0.0,
                        sample0: int = 0):
    """K5b: (dq, dk, dv) of field attention from the forward's inputs, its
    output ``o`` and log-sum-exp ``lse`` (h, F, B), and the output gradient
    ``do``; the dropout mask is regenerated from ``seed`` (an int or a key
    tensor), ``rate`` and ``sample0``.
    The kernel computes each (query, key, sample) term once and sums in a
    fixed order, so two calls on the same inputs give the same bits."""
    _check_qkv(q, k, v)
    _check_rate(rate)
    _check_seed(seed, q.device)
    require(o, "o", torch.float32, q.shape, q.device)
    require(do, "do", torch.float32, q.shape, q.device)
    h, dh, f, b = q.shape
    require(lse, "lse", torch.float32, (h, f, b), q.device)
    if q.device.type == "cpu":
        return field_attention_bwd_reference(q, k, v, o, lse, do, _int_seed(seed), rate,
                                             sample0)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    # a bf16 dq's partial sums over the key chunks before the last stay
    # float32 (a float32 dq holds its own)
    dq_acc = dq
    if q.dtype == torch.bfloat16:
        dq_acc = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
                  if f > bwd_keys_per_chunk(dh) else None)
    lib = library("field_attention")
    with torch.cuda.device(q.device):
        code = lib.field_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
            None if dq_acc is None else dq_acc.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), h, dh, f, b, 1.0 / dh ** 0.5,
            *_dropout_args(_card_key(seed, q.device, rate), rate, sample0),
            int(q.dtype == torch.bfloat16), stream_handle(q.device))
    check(lib, code, "field_attention_bwd")
    count_launch("field_attention_bwd")
    return dq, dk, dv


class FieldAttentionFunction(torch.autograd.Function):
    """Field attention with K5b as its backward.  On a card with dropout,
    an int seed becomes a key tensor once, which K5f and K5b both read."""

    @staticmethod
    def forward(ctx, q, k, v, seed, rate: float, sample0: int):
        if q.device.type == "cuda":
            seed = _card_key(seed, q.device, rate) if rate > 0.0 else 0
        o, lse = _fwd(q, k, v, seed, rate, True, sample0)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.seed, ctx.rate, ctx.sample0 = seed, rate, sample0
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = field_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.seed, ctx.rate, ctx.sample0)
        return dq, dk, dv, None, None, None


def field_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seed=0, rate: float = 0.0,
                    sample0: Optional[int] = None) -> torch.Tensor:
    """softmax(q.k / sqrt(dh)) . v over fields, with attention-weight
    dropout at ``rate`` drawn from ``seed`` (a non-negative int below
    2**64, or a key tensor on q's device) for samples numbered from
    ``sample0`` (None: ``sample_offset``'s, 0 outside one); q/k/v ``(h,
    dh, F, B)`` contiguous, on one device, all float32 or all bfloat16;
    returns ``(h, dh, F, B)`` float32, differentiable in q, k and v (their
    gradients in their type)."""
    _check_qkv(q, k, v)
    _check_rate(rate)
    _check_seed(seed, q.device)
    sample0 = _SAMPLE0.get() if sample0 is None else sample0
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FieldAttentionFunction.apply(q, k, v, seed, rate, sample0)
    return _fwd(q, k, v, seed, rate, False, sample0)[0]
