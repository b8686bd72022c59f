"""Field attention for the InteractingLayer: the forward of K5.

Counterpart of ``recommendsystem_tpu/kernels/field_attention_pallas.py``.
``field_attention`` keeps the JAX public layout: q/k/v of shape
``(head, d_head, F, B)`` float32, batch-minor.  On a CUDA tensor it launches
the hand-written kernel of ``csrc/field_attention.cu`` (one thread per
(head, query field, sample), k/v tiles staged in shared memory, online
softmax over keys); on a CPU tensor it runs ``field_attention_reference``.

This slice has the forward at rate 0 only: attention-weight dropout (Philox
in the kernel) and the backward kernel come with slice 2 of the port, so on
CUDA the wrapper refuses inputs that need a gradient.
"""

from __future__ import annotations

import torch

from ._build import check, count_launch, library, require, stream_handle

SUPPORTED_D_HEAD = (1, 2, 4, 8, 16, 32)


def field_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain version: softmax over keys of q.k / sqrt(dh), times v, with
    every (head, F, F, B) score materialised."""
    dh = q.shape[1]
    s = torch.einsum("hdfb,hdgb->hfgb", q, k) / (dh ** 0.5)
    p = torch.softmax(s, dim=2)
    return torch.einsum("hfgb,hdgb->hdfb", p, v)


def field_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seed: int = 0, rate: float = 0.0) -> torch.Tensor:
    """softmax(q.k / sqrt(dh)) . v over fields; q/k/v ``(h, dh, F, B)``
    float32 contiguous, on one device; returns ``(h, dh, F, B)`` float32.
    ``seed`` is unused at ``rate == 0``, the only rate of this slice."""
    if rate != 0.0:
        raise NotImplementedError(
            f"field_attention with dropout rate {rate}: attention-weight "
            f"dropout comes with slice 2 of the port")
    require(q, "q", torch.float32)
    if q.ndim != 4:
        raise ValueError(f"q: expected (head, d_head, F, B), got {tuple(q.shape)}")
    require(k, "k", torch.float32, q.shape, q.device)
    require(v, "v", torch.float32, q.shape, q.device)
    if q.device.type == "cpu":
        return field_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"field_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "field_attention on CUDA is forward-only: its backward kernel "
            "comes with slice 2 of the port")
    h, dh, f, b = q.shape
    if dh not in SUPPORTED_D_HEAD:
        raise ValueError(f"field_attention: d_head {dh} not in {SUPPORTED_D_HEAD}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = library("field_attention")
    with torch.cuda.device(q.device):
        code = lib.field_attention_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), h, dh, f,
            b, 1.0 / dh ** 0.5, stream_handle(q.device))
    check(lib, code, "field_attention")
    count_launch("field_attention")
    return out
