"""The forward kernels a predict call reaches, as opaque PyTorch custom ops.

Each op ``recommendsystem_tpu_torch::<name>`` has three implementations:

- on CUDA tensors, the kernel's launcher (which counts its launch with
  ``_build.count_launch``, so a loaded exported program's launches are
  counted as the step's are);
- on CPU tensors, the kernel's plain PyTorch version;
- a fake one, which gives a tracer (``torch.export``) the outputs' shapes
  and types without running anything.

So ``torch.export`` keeps each kernel as one node of the graph, in place of
tracing through the ``ctypes`` launch (which reads ``data_ptr()``) or the
plain version's ``aten`` ops.  A tensor on any other device has no
implementation and raises.  The ops are the forward launchers of K1 and
K2 (``embedding/packed.py``), K7 with its facts given and gathering them
(``kernels/din.py``), K6 (``kernels/interacting.py``) and K5f
(``kernels/field_attention.py``), and K10, the low-rank cross layer's
elementwise backward (``kernels/dcn_cross.py``), which mutates its
``dx0``; each wrapper there checks shapes and types before it calls its
op, and each launcher checks alignment on the card.  The other training
kernels (K3, K4, K5b, K8, K9) stay direct ``ctypes`` calls.

The launchers and plain versions are imported inside each implementation:
their modules import this one.  Importing this module registers the ops;
``train/export.py`` imports it before it loads an exported program.
"""

from typing import List, Tuple

import torch

NAMESPACE = "recommendsystem_tpu_torch"
_U64 = 1 << 64


def op(name: str):
    """``torch.ops.recommendsystem_tpu_torch.<name>``."""
    return getattr(getattr(torch.ops, NAMESPACE), name)


def signed_seed(seed: int) -> int:
    """A seed in [0, 2**64) as the int64 an op's schema takes."""
    return seed - _U64 if seed >= 1 << 63 else seed


# ---------------------------------------------------------------------------
# K1, K2: the grouped folds
# ---------------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::fold_mean_group", mutates_args=(),
                         device_types="cuda")
def fold_mean_group(tables: List[torch.Tensor], ids: List[torch.Tensor],
                    masks: List[torch.Tensor], cs: List[int],
                    ls: List[int]) -> List[torch.Tensor]:
    from ..embedding import packed
    return packed.fold_mean_launch(list(zip(tables, ids, masks, cs, ls)))


@fold_mean_group.register_kernel("cpu")
def _fold_mean_group_cpu(tables, ids, masks, cs, ls):
    from ..embedding.packed import fold_mean_plain
    return [fold_mean_plain(*m) for m in zip(tables, ids, masks, cs, ls)]


@fold_mean_group.register_fake
def _fold_mean_group_fake(tables, ids, masks, cs, ls):
    return [t.new_empty((i.shape[0] // l, t.shape[1]), dtype=torch.float32)
            for t, i, l in zip(tables, ids, ls)]


@torch.library.custom_op(f"{NAMESPACE}::fold_rows_group", mutates_args=(),
                         device_types="cuda")
def fold_rows_group(tables: List[torch.Tensor], ids: List[torch.Tensor],
                    masks: List[torch.Tensor]) -> List[torch.Tensor]:
    from ..embedding import packed
    return packed.fold_rows_launch(list(zip(tables, ids, masks)))


@fold_rows_group.register_kernel("cpu")
def _fold_rows_group_cpu(tables, ids, masks):
    from ..embedding.packed import fold_rows_plain
    return [fold_rows_plain(*m) for m in zip(tables, ids, masks)]


@fold_rows_group.register_fake
def _fold_rows_group_fake(tables, ids, masks):
    return [t.new_empty((i.shape[0], t.shape[1]), dtype=torch.float32)
            for t, i in zip(tables, ids)]


# ---------------------------------------------------------------------------
# K7: the DIN pool, facts given and gathered
# ---------------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::din_pool", mutates_args=(), device_types="cuda")
def din_pool(query: torch.Tensor, facts: torch.Tensor, mask: torch.Tensor,
             w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor) -> torch.Tensor:
    from . import din
    return din.din_pool_launch(query, facts, mask, w1, b1, w2, b2)


@din_pool.register_kernel("cpu")
def _din_pool_cpu(query, facts, mask, w1, b1, w2, b2):
    from .din import din_pool_plain
    return din_pool_plain(query, facts, mask, w1, b1, w2, b2)


@din_pool.register_fake
def _din_pool_fake(query, facts, mask, w1, b1, w2, b2):
    return facts.new_empty((facts.shape[0], facts.shape[2]), dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::din_pool_gather", mutates_args=(),
                         device_types="cuda")
def din_pool_gather(query: torch.Tensor, table: torch.Tensor, ids: torch.Tensor,
                    mask: torch.Tensor, lo: int, hi: int, w1: torch.Tensor,
                    b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                    facts_dtype: torch.dtype) -> torch.Tensor:
    from . import din
    return din.din_pool_gather_launch(query, table, ids, mask, (lo, hi), w1, b1, w2, b2,
                                      facts_dtype)


@din_pool_gather.register_kernel("cpu")
def _din_pool_gather_cpu(query, table, ids, mask, lo, hi, w1, b1, w2, b2, facts_dtype):
    from .din import din_pool_gather_plain
    return din_pool_gather_plain(query, table, ids, mask, (lo, hi), w1, b1, w2, b2,
                                 facts_dtype)


@din_pool_gather.register_fake
def _din_pool_gather_fake(query, table, ids, mask, lo, hi, w1, b1, w2, b2, facts_dtype):
    return table.new_empty((ids.shape[0], query.shape[1]), dtype=torch.float32)


# ---------------------------------------------------------------------------
# K6: one fused InteractingLayer iteration
# ---------------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::interacting_attention", mutates_args=(),
                         device_types="cuda")
def interacting_attention(x: torch.Tensor, wq: torch.Tensor, bq: torch.Tensor,
                          wk: torch.Tensor, bk: torch.Tensor, wv: torch.Tensor,
                          bv: torch.Tensor, wr: torch.Tensor, br: torch.Tensor,
                          gamma: torch.Tensor, beta: torch.Tensor, head_num: int,
                          ln_eps: float) -> torch.Tensor:
    from . import interacting
    params = (wq, bq, wk, bk, wv, bv, wr, br, gamma, beta)
    return interacting.interacting_launch(
        x, dict(zip(interacting.PARAM_NAMES, params)), head_num, ln_eps)


@interacting_attention.register_kernel("cpu")
def _interacting_attention_cpu(x, wq, bq, wk, bk, wv, bv, wr, br, gamma, beta,
                               head_num, ln_eps):
    from . import interacting
    params = (wq, bq, wk, bk, wv, bv, wr, br, gamma, beta)
    return interacting.interacting_attention_plain(
        x, dict(zip(interacting.PARAM_NAMES, params)), head_num, ln_eps)


@interacting_attention.register_fake
def _interacting_attention_fake(x, wq, bq, wk, bk, wv, bv, wr, br, gamma, beta,
                                head_num, ln_eps):
    return x.new_empty((x.shape[0], x.shape[1], wq.shape[1]), dtype=torch.float32)


# ---------------------------------------------------------------------------
# K5f: the field attention's forward
# ---------------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::field_attention_fwd", mutates_args=(),
                         device_types="cuda")
def field_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: int,
                        rate: float, want_lse: bool,
                        sample0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse); lse is empty (0 elements) unless ``want_lse``.  ``seed``
    is ``signed_seed`` of the dropout seed, ``sample0`` the global index of
    the first sample in the dropout counter."""
    from . import field_attention
    key = field_attention.dropout_key(seed % _U64, q.device) if rate > 0.0 else None
    return field_attention.fwd_launch(q, k, v, key, rate, want_lse, sample0)


@field_attention_fwd.register_kernel("cpu")
def _field_attention_fwd_cpu(q, k, v, seed, rate, want_lse, sample0=0):
    from . import field_attention as fa
    if want_lse:
        return fa.field_attention_fwd_plain(q, k, v, seed % _U64, rate, sample0)
    o = fa.field_attention_reference(q, k, v, seed % _U64, rate, sample0)
    return o, q.new_empty((0,), dtype=torch.float32)


@field_attention_fwd.register_fake
def _field_attention_fwd_fake(q, k, v, seed, rate, want_lse, sample0=0):
    h, _, f, b = q.shape
    lse = (h, f, b) if want_lse else (0,)
    return (q.new_empty(q.shape, dtype=torch.float32),
            q.new_empty(lse, dtype=torch.float32))


# ---------------------------------------------------------------------------
# K10: the low-rank cross layer's elementwise backward
# ---------------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::dcn_cross_bwd", mutates_args=("dx0",),
                         device_types="cuda")
def dcn_cross_bwd(g: torch.Tensor, x0: torch.Tensor, u: torch.Tensor, dx0: torch.Tensor,
                  accumulate: bool, residual: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(du, the partial sums of db); x_0's gradient accumulated into
    ``dx0``."""
    from . import dcn_cross
    return dcn_cross.dcn_cross_bwd_launch(g, x0, u, dx0, accumulate, residual)


@dcn_cross_bwd.register_kernel("cpu")
def _dcn_cross_bwd_cpu(g, x0, u, dx0, accumulate, residual):
    from .dcn_cross import dcn_cross_bwd_plain
    return dcn_cross_bwd_plain(g, x0, u, dx0, accumulate, residual)


@dcn_cross_bwd.register_fake
def _dcn_cross_bwd_fake(g, x0, u, dx0, accumulate, residual):
    from .dcn_cross import tiles_of
    return torch.empty_like(g), g.new_empty((tiles_of(g.shape[0]), g.shape[1]))
