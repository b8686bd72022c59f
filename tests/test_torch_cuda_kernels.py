"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker, needs a CUDA card and skips
without one (the ``cuda`` fixture decides, at run time).  The file imports
no JAX, so it also runs where JAX is absent, without the suite's conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: folds atol 1e-6 (sums of <= 5 float32 products in another
order), the grouped per-row fold exact (one product, one rounding), the grouped folds (L up to 10, rows of any scale) atol 1e-6 plus
2L units of 2^-24 of each output's sum of |mask * row| (``_assert_fold``); attention atol 2e-5 (softmax over <= 175 keys in another order),
its gradients rtol 1e-4 and atol 2e-5 (sums over <= 175 fields); the
unfold-scatter's gradient sums atol 1e-5, or 1e-6 per entry that hits one
row (atomics add in another order on every run), its counts exact; the
lazy Adam's m and v rtol 1e-6 and w atol 1e-7 (``powf`` on the card against
PyTorch's pow: one ulp in a bias correction), t and show exact, rows with
count 0 bit-identical; the lazy AdaGrad's w atol 1e-6 and g2sum rtol 1e-6
(the squares summed in another order), show exact, rows with count 0
bit-identical; the DIN
pool atol 2e-5 (a softmax over T and 4H-term dots in another order, as the
JAX package holds its own kernel), its gradients rtol 1e-4, atol 1e-5; the
fused InteractingLayer iteration rtol and atol 2e-5 (the JAX package's own
for it), its gradients rtol 1e-4, atol 1e-5.  Over bf16 tables and moments
(K1, K2, K7's gathering entry, K8, K9): the float32 outputs as above, and
each stored bf16 entry equal to the plain version's or one bf16 ulp from
it where the plain version's float32 value lies within the float32
tolerance of the rounding midpoint (``_assert_bf16``).
"""

import pytest
import torch

from recommendsystem_tpu_torch.embedding import packed
from recommendsystem_tpu_torch.embedding.optimizers import SparseAdam
from recommendsystem_tpu_torch.kernels.din import (din_pool, din_pool_gather,
                                                   din_pool_gather_plain, din_pool_plain)
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.kernels.interacting import (
    PARAM_NAMES,
    interacting_attention,
    interacting_attention_plain,
)
from recommendsystem_tpu_torch.kernels.field_attention import (
    field_attention,
    field_attention_bwd,
    field_attention_bwd_reference,
    field_attention_fwd_plain,
    field_attention_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in float32
    reset_launch_counts()
    return torch.device("cuda")


def _stream(dev, rows, c, l, b, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(0, l + 1, (c, 1, b), generator=g, device=dev)
    mask = (torch.arange(l, device=dev)[None, :, None] < lens).float()
    ids = torch.randint(0, rows, (c, l, b), generator=g, device=dev,
                        dtype=torch.int32) * mask.int()
    return ids.reshape(-1), mask.reshape(-1)


@pytest.mark.parametrize("c,l,b", [(1, 5, 8), (24, 5, 200), (1, 5, 4097), (3, 2, 1)])
def test_fold_mean_kernel(cuda, c, l, b):
    table = torch.randn(1000, 8, device=cuda)
    ids, mask = _stream(cuda, 1000, c, l, b, seed=b)
    got = packed.fold_mean(table, ids, mask, c, l)
    want = packed.fold_mean_plain(table, ids, mask, c, l)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert launch_counts()["fold_mean"] == 1


@pytest.mark.parametrize("e,d", [(8, 8), (200, 8), (4097, 3), (256, 16)])
def test_fold_rows_kernel(cuda, e, d):
    table = torch.randn(500, d, device=cuda)
    ids, mask = _stream(cuda, 500, 1, 1, e, seed=e)
    got = packed.fold_rows(table, ids, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, packed.fold_rows_plain(table, ids, mask),
                               rtol=0, atol=1e-6)
    assert launch_counts()["fold_rows"] == 1


@pytest.mark.parametrize("h,dh,f,b", [(2, 4, 24, 8), (2, 4, 24, 200),
                                      (2, 4, 175, 256), (1, 8, 40, 33),
                                      (3, 2, 1, 5), (2, 32, 9, 64)])
def test_field_attention_kernel(cuda, h, dh, f, b):
    g = torch.Generator(device=cuda).manual_seed(f * b)
    q, k, v = (torch.randn((h, dh, f, b), generator=g, device=cuda) for _ in range(3))
    got = field_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, field_attention_reference(q, k, v),
                               rtol=0, atol=2e-5)
    assert launch_counts()["field_attention"] == 1


@pytest.mark.parametrize("h,dh,f,b", [(2, 4, 24, 200), (2, 4, 175, 256),
                                      (1, 8, 40, 33), (3, 2, 1, 5)])
def test_field_attention_dropout_kernel(cuda, h, dh, f, b):
    """Rate 0.2: the kernel draws the plain version's mask bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(f * b + 1)
    q, k, v = (torch.randn((h, dh, f, b), generator=g, device=cuda) for _ in range(3))
    seed = (123 << 32) | 4
    got = field_attention(q, k, v, seed, 0.2)
    torch.testing.assert_close(got, field_attention_reference(q, k, v, seed, 0.2),
                               rtol=0, atol=2e-5)
    o, lse = field_attention_fwd_plain(q, k, v, seed, 0.2)
    torch.testing.assert_close(got, o, rtol=0, atol=2e-5)
    assert launch_counts()["field_attention"] == 1


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("h,dh,f,b", [(2, 4, 24, 200), (2, 4, 175, 96),
                                      (1, 8, 40, 33), (3, 2, 1, 5), (2, 32, 9, 64),
                                      (2, 4, 1, 40), (1, 4, 256, 33), (1, 32, 70, 17),
                                      (2, 1, 37, 70), (1, 16, 30, 45)])
def test_field_attention_bwd_kernel(cuda, h, dh, f, b, rate):
    g = torch.Generator(device=cuda).manual_seed(f * b + 2)
    q, k, v, do = (torch.randn((h, dh, f, b), generator=g, device=cuda)
                   for _ in range(4))
    o, lse = field_attention_fwd_plain(q, k, v, 9, rate)
    got = field_attention_bwd(q, k, v, o, lse, do, 9, rate)
    want = field_attention_bwd_reference(q, k, v, o, lse, do, 9, rate)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=2e-5)
    assert launch_counts()["field_attention_bwd"] == 1


@pytest.mark.parametrize("f,b", [(24, 300), (175, 64)])
def test_field_attention_bwd_is_deterministic(cuda, f, b):
    """Every sum of K5b runs in a fixed order: two launches, the same bits."""
    g = torch.Generator(device=cuda).manual_seed(f + b)
    q, k, v, do = (torch.randn((2, 4, f, b), generator=g, device=cuda) for _ in range(4))
    o, lse = field_attention_fwd_plain(q, k, v, 3, 0.2)
    first = field_attention_bwd(q, k, v, o, lse, do, 3, 0.2)
    second = field_attention_bwd(q, k, v, o, lse, do, 3, 0.2)
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    assert launch_counts()["field_attention_bwd"] == 2


def test_field_attention_autograd_runs_both_kernels(cuda):
    q, k, v = (torch.randn((2, 4, 24, 300), device=cuda, requires_grad=True)
               for _ in range(3))
    do = torch.randn((2, 4, 24, 300), device=cuda)
    got = torch.autograd.grad(field_attention(q, k, v, 5, 0.2), (q, k, v), do)
    want = torch.autograd.grad(field_attention_reference(q, k, v, 5, 0.2), (q, k, v), do)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=2e-5)
    assert launch_counts()["field_attention"] == 1
    assert launch_counts()["field_attention_bwd"] == 1


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dh", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("f", [1, 24, 175, 256])
def test_field_attention_fwd_lse_kernel(cuda, f, dh, rate):
    """K5f as the train step launches it (with the log-sum-exp): output and
    lse against the plain version's, at a B that is not a multiple of the
    block's 32 samples."""
    from recommendsystem_tpu_torch.kernels.field_attention import _fwd
    b = 45
    g = torch.Generator(device=cuda).manual_seed(f * dh + int(rate * 10))
    q, k, v = (torch.randn((2, dh, f, b), generator=g, device=cuda) for _ in range(3))
    seed = (77 << 32) | 3
    got, got_lse = _fwd(q, k, v, seed, rate, want_lse=True)
    want, want_lse = field_attention_fwd_plain(q, k, v, seed, rate)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    torch.testing.assert_close(got_lse, want_lse, rtol=0, atol=2e-5)
    assert launch_counts()["field_attention"] == 1


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dh", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("f", [1, 24, 175])
def test_field_attention_fwd_lse_kernel_wide_batch(cuda, f, dh, rate):
    """As above at B = 4500 (141 blocks of 32 samples a head, more than the
    card's SMs): each thread takes several queries and a block every query
    tile, where the small batches spread the tiles over the grid."""
    from recommendsystem_tpu_torch.kernels.field_attention import _fwd
    b = 4500
    g = torch.Generator(device=cuda).manual_seed(f * dh + int(rate * 10) + 1)
    q, k, v = (torch.randn((2, dh, f, b), generator=g, device=cuda) for _ in range(3))
    seed = (78 << 32) | 5
    got, got_lse = _fwd(q, k, v, seed, rate, want_lse=True)
    want, want_lse = field_attention_fwd_plain(q, k, v, seed, rate)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    torch.testing.assert_close(got_lse, want_lse, rtol=0, atol=2e-5)
    assert launch_counts()["field_attention"] == 1


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("b", [40, 4500])
def test_field_attention_fwd_loose_bound(cuda, b, rate):
    """Keys 0 and 1 hold (20, -20) and (-20, 20), the queries about (2, 2):
    scores stay small, while the kernel's bound on a row's largest score,
    sum_d max(q_d kmax_d, q_d kmin_d), is ~80 (base 2) higher.  The rows'
    sums fall below 2^-64 and the kernel does them again exactly."""
    from recommendsystem_tpu_torch.kernels.field_attention import _fwd
    g = torch.Generator(device=cuda).manual_seed(b + 3)
    q = torch.randn((2, 2, 24, b), generator=g, device=cuda) * 0.1 + 2.0
    k = torch.randn((2, 2, 24, b), generator=g, device=cuda) * 0.3
    v = torch.randn((2, 2, 24, b), generator=g, device=cuda)
    k[:, :, 0] = torch.tensor([20.0, -20.0], device=cuda)[None, :, None]
    k[:, :, 1] = torch.tensor([-20.0, 20.0], device=cuda)[None, :, None]
    got, got_lse = _fwd(q, k, v, 11, rate, want_lse=True)
    want, want_lse = field_attention_fwd_plain(q, k, v, 11, rate)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.isfinite(got_lse).all()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    torch.testing.assert_close(got_lse, want_lse, rtol=0, atol=2e-5)


@pytest.mark.parametrize("f,b,rate", [(24, 300, 0.2), (175, 300, 0.2), (40, 300, 0.0),
                                      (24, 4500, 0.2), (175, 4500, 0.2)])
def test_field_attention_fwd_is_deterministic(cuda, f, b, rate):
    """K5f sums in a fixed order: two launches, the same bits."""
    from recommendsystem_tpu_torch.kernels.field_attention import _fwd
    g = torch.Generator(device=cuda).manual_seed(f + 11)
    q, k, v = (torch.randn((2, 4, f, b), generator=g, device=cuda) for _ in range(3))
    first = _fwd(q, k, v, 5, rate, want_lse=True)
    second = _fwd(q, k, v, 5, rate, want_lse=True)
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    assert launch_counts()["field_attention"] == 2


@pytest.mark.parametrize("f,b", [(24, 200), (175, 70), (256, 33), (24, 4500)])
def test_field_attention_bwd_from_the_kernel_lse(cuda, f, b):
    """K5b fed K5f's own output and lse stays within the gradients'
    tolerance of the plain backward fed the plain forward's."""
    from recommendsystem_tpu_torch.kernels.field_attention import _fwd
    g = torch.Generator(device=cuda).manual_seed(f * b + 5)
    q, k, v, do = (torch.randn((2, 4, f, b), generator=g, device=cuda) for _ in range(4))
    o, lse = _fwd(q, k, v, 6, 0.2, want_lse=True)
    got = field_attention_bwd(q, k, v, o, lse, do, 6, 0.2)
    po, plse = field_attention_fwd_plain(q, k, v, 6, 0.2)
    want = field_attention_bwd_reference(q, k, v, po, plse, do, 6, 0.2)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=2e-5)
    assert launch_counts()["field_attention"] == 1
    assert launch_counts()["field_attention_bwd"] == 1


def _unfold_inputs(dev, rows, l, b, seed, hot_row=False, d=8):
    ids, mask = _stream(dev, rows, 1, l, b, seed)
    if hot_row:
        ids = torch.full_like(ids, 7)          # every entry on one row
    g = torch.randn((b, d), generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev)
    return g, ids, mask


def _assert_unfold(got, want, d):
    """Gradient sums within 1e-5, or 1e-6 per entry on the busiest row;
    counts exact."""
    (gg, gc), (wg, wc) = packed.accumulator_views(got, d), packed.accumulator_views(want, d)
    per_row = float(wc.max()) if wc.numel() else 0.0
    torch.testing.assert_close(gg, wg, rtol=0, atol=max(1e-5, 1e-6 * per_row))
    torch.testing.assert_close(gc, wc, rtol=0, atol=0)


@pytest.mark.parametrize("l,b,hot", [(5, 8, False), (5, 4097, False),
                                     (2, 200, False), (5, 4096, True)])
def test_unfold_mean_scatter_kernel(cuda, l, b, hot):
    g, ids, mask = _unfold_inputs(cuda, 1000, l, b, seed=b + l, hot_row=hot)
    got = torch.zeros(1000 * 9, device=cuda)
    want = torch.zeros(1000 * 9, device=cuda)
    packed.unfold_mean_scatter(*packed.accumulator_views(got, 8), g, ids, mask, l)
    packed.unfold_mean_scatter_plain(*packed.accumulator_views(want, 8), g, ids, mask, l)
    torch.cuda.synchronize()
    _assert_unfold(got, want, 8)
    assert launch_counts()["unfold_mean"] == 1


@pytest.mark.parametrize("e,hot", [(8, False), (4097, False), (65536, True)])
def test_unfold_rows_scatter_kernel(cuda, e, hot):
    g, ids, mask = _unfold_inputs(cuda, 500, 1, e, seed=e, hot_row=hot)
    got = torch.zeros(500 * 9, device=cuda)
    want = torch.zeros(500 * 9, device=cuda)
    packed.unfold_rows_scatter(*packed.accumulator_views(got, 8), g, ids, mask)
    packed.unfold_rows_scatter_plain(*packed.accumulator_views(want, 8), g, ids, mask)
    torch.cuda.synchronize()
    _assert_unfold(got, want, 8)
    assert launch_counts()["unfold_rows"] == 1


# grouped K1 and K3: (D, L, B, hot) per member; D 3 and 5 take one float a
# lane, the others float4 lanes; B 0 is an empty member
GROUP_MEMBERS = [(8, 5, 300, False), (16, 2, 77, False), (32, 10, 129, False),
                 (48, 7, 64, True), (56, 3, 1, False), (8, 10, 0, False),
                 (3, 4, 50, False), (5, 9, 33, True)]


def _table(dev, rows, d, seed):
    return torch.randn(rows, d, generator=torch.Generator(device=dev).manual_seed(seed),
                       device=dev)


def _assert_fold(got, item):
    """The grouped fold against its plain version: within 1e-6 plus 2L
    units of 2^-24 of each output's sum of |mask * row| over its L slots.
    Either side's float32 sum of L products (the kernel's with fused
    multiply-adds, in slot order; the plain one in its own order) lies
    within L such units of the exact sum."""
    table, ids, mask, c, l = item
    want = packed.fold_mean_plain(*item)
    scale = packed.fold_mean_plain(table.abs(), ids, mask.abs(), c, l)
    excess = (got - want).abs() - 2 * l * 2.0 ** -24 * scale
    assert got.shape == want.shape
    assert not excess.numel() or float(excess.max()) <= 1e-6


def _fold_members(dev, members, rows=700, c=2):
    items = []
    for i, (d, l, b, hot) in enumerate(members):
        table = _table(dev, rows, d, i)
        ids, mask = _stream(dev, rows, c, l, b, seed=100 + i)
        if hot:
            ids = torch.where(mask > 0, torch.full_like(ids, 3), ids)
        items.append((table, ids, mask, c, l))
    return items


def test_fold_mean_group_kernel(cuda):
    """One grouped launch over members of D 8-56 (float4 lanes) and 3, 5
    (one float a lane), L 2-10, a hot row and an empty member, each against
    its plain version."""
    items = _fold_members(cuda, GROUP_MEMBERS)
    got = packed.fold_mean_group(items)
    torch.cuda.synchronize()
    assert launch_counts()["fold_mean"] == 1
    assert len(got) == len(items)
    for out, item in zip(got, items):
        _assert_fold(out, item)


def test_fold_mean_group_unaligned_table(cuda):
    """A table whose rows are not 16-byte aligned takes one float a lane."""
    flat = torch.cat([torch.zeros(1, device=cuda), _table(cuda, 500, 8, 7).reshape(-1)])
    table = flat[1:].view(500, 8)
    ids, mask = _stream(cuda, 500, 3, 5, 90, seed=4)
    (got,) = packed.fold_mean_group([(table, ids, mask, 3, 5)])
    _assert_fold(got, (table, ids, mask, 3, 5))


def test_fold_mean_group_of_65_members(cuda):
    """65 members: two launches of at most 64."""
    members = [(8 * (1 + i % 3), 2 + i % 9, 20 + i, i % 7 == 0) for i in range(65)]
    items = _fold_members(cuda, members, rows=300, c=1)
    got = packed.fold_mean_group(items)
    torch.cuda.synchronize()
    assert launch_counts()["fold_mean"] == 2
    for out, item in zip(got, items):
        _assert_fold(out, item)


def _unfold_members(dev, members, rows=700):
    items = []
    for i, (d, l, b, hot) in enumerate(members):
        g, ids, mask = _unfold_inputs(dev, rows, l, b, seed=200 + i, hot_row=hot, d=d)
        acc = torch.zeros(rows * (d + 1), device=dev)
        items.append((*packed.accumulator_views(acc, d), g, ids, mask, l))
    return items


def _flat(grads, counts):
    """The flat accumulator that ``accumulator_views`` split."""
    return torch.cat([grads.reshape(-1), counts.reshape(-1)])


def _check_unfold_group(items):
    for grads, counts, g, ids, mask, l in items:
        want = torch.zeros_like(_flat(grads, counts))
        packed.unfold_mean_scatter_plain(*packed.accumulator_views(want, g.shape[1]),
                                         g, ids, mask, l)
        _assert_unfold(_flat(grads, counts), want, g.shape[1])


def _rows_members(dev, members, rows=700):
    """(table, ids, mask) members of (D, E, hot): a quarter of the entries
    masked over random (nonzero-row) padding ids; hot members put every
    live entry on row 3."""
    items = []
    for i, (d, e, hot) in enumerate(members):
        g = torch.Generator(device=dev).manual_seed(300 + i)
        ids = torch.randint(0, rows, (e,), generator=g, device=dev, dtype=torch.int32)
        mask = (torch.rand((e,), generator=g, device=dev) > 0.25).float()
        if hot:
            ids = torch.where(mask > 0, torch.full_like(ids, 3), ids)
        items.append((_table(dev, rows, d, i), ids, mask))
    return items


def _assert_rows(got, items):
    """Each member of a grouped per-row fold equal to its plain version:
    one product per output, rounded once on either side."""
    assert len(got) == len(items)
    for out, item in zip(got, items):
        torch.testing.assert_close(out, packed.fold_rows_plain(*item), rtol=0, atol=0)


# the grouped per-row fold: D 3 and 5 take one float a lane, the others
# float4 lanes; E 0 is an empty member; the staytime sequence shape last
ROWS_MEMBERS = [(8, 256, False), (32, 1000, False), (56, 77, True), (8, 0, False),
                (3, 50, False), (5, 33, True), (16, 4097, False), (32, 64 * 50, False)]


def test_fold_rows_group_kernel(cuda):
    items = _rows_members(cuda, ROWS_MEMBERS)
    got = packed.fold_rows_group(items)
    torch.cuda.synchronize()
    assert launch_counts()["fold_rows"] == 1
    _assert_rows(got, items)


def test_fold_rows_group_of_65_members(cuda):
    """65 members: two launches of at most 64."""
    items = _rows_members(cuda, [(8 * (1 + i % 4), 20 + 13 * i, i % 7 == 0)
                                 for i in range(65)], rows=300)
    got = packed.fold_rows_group(items)
    torch.cuda.synchronize()
    assert launch_counts()["fold_rows"] == 2
    _assert_rows(got, items)


def test_fold_rows_group_unaligned_table(cuda):
    """A table whose rows are not 16-byte aligned takes one float a lane."""
    flat = torch.cat([torch.zeros(1, device=cuda), _table(cuda, 500, 8, 7).reshape(-1)])
    ((_, ids, mask),) = _rows_members(cuda, [(8, 333, False)], rows=500)
    item = (flat[1:].view(500, 8), ids, mask)
    _assert_rows(packed.fold_rows_group([item]), [item])


def test_unfold_mean_group_kernel(cuda):
    """One grouped launch over members of D 8-56 and 3, 5, L 2-10, hot
    rows and an empty member; two members share one accumulator."""
    items = _unfold_members(cuda, GROUP_MEMBERS)
    g, ids, mask = _unfold_inputs(cuda, 700, 4, 111, seed=9)
    items.append((*items[0][:2], g, ids, mask, 4))     # the first member's accumulator
    packed.unfold_mean_scatter_group(items)
    torch.cuda.synchronize()
    assert launch_counts()["unfold_mean"] == 1
    want = torch.zeros_like(_flat(*items[0][:2]))
    for _, _, g, ids, mask, l in (items[0], items[-1]):
        packed.unfold_mean_scatter_plain(*packed.accumulator_views(want, 8), g, ids, mask, l)
    _assert_unfold(_flat(*items[0][:2]), want, 8)
    _check_unfold_group(items[1:-1])


@pytest.mark.parametrize("n,launches", [(64, 1), (65, 1), (91, 1), (512, 1), (513, 2)])
def test_unfold_mean_group_takes_512_members_a_launch(cuda, n, launches):
    """Up to 512 mean columns a launch in the ~30 KB parameter struct
    (staytime's 91: one launch), 513 in two."""
    members = [(8 * (1 + i % 3), 2 + i % 9, 20 + i % 50, i % 7 == 0) for i in range(n)]
    items = _unfold_members(cuda, members, rows=300)
    packed.unfold_mean_scatter_group(items)
    torch.cuda.synchronize()
    assert launch_counts()["unfold_mean"] == launches
    _check_unfold_group(items)


def test_unfold_mean_group_unaligned_gradient(cuda):
    """A gradient whose rows are not 16-byte aligned takes one float a lane."""
    g, ids, mask = _unfold_inputs(cuda, 400, 5, 70, seed=3)
    g = torch.cat([torch.zeros(1, device=cuda), g.reshape(-1)])[1:].view(70, 8)
    got = torch.zeros(400 * 9, device=cuda)
    want = torch.zeros(400 * 9, device=cuda)
    packed.unfold_mean_scatter_group([(*packed.accumulator_views(got, 8), g, ids, mask, 5)])
    packed.unfold_mean_scatter_plain(*packed.accumulator_views(want, 8), g, ids, mask, 5)
    _assert_unfold(got, want, 8)


def _rows_unfold_members(dev, members, rows=700):
    """K4 members (grads, counts, g, ids, mask) of (D, E, hot), each into
    its own accumulator."""
    return [item[:5] for item in _unfold_members(dev, [(d, 1, e, hot)
                                                       for d, e, hot in members], rows)]


def _check_rows_unfold(items):
    """Each accumulator against the plain version of every member that adds
    into it, in order."""
    wants = {}
    for grads, counts, g, ids, mask in items:
        key = grads.data_ptr()
        if key not in wants:
            wants[key] = (grads, counts, torch.zeros_like(_flat(grads, counts)))
        packed.unfold_rows_scatter_plain(*packed.accumulator_views(wants[key][2], g.shape[1]),
                                         g, ids, mask)
    for grads, counts, want in wants.values():
        _assert_unfold(_flat(grads, counts), want, grads.shape[1])


def test_unfold_rows_group_kernel(cuda):
    """One grouped K4 launch over members of D 8-56 and 3, 5, hot rows and
    an empty member; three members share one accumulator."""
    items = _rows_unfold_members(cuda, [(8, 300, False), (16, 77, False), (56, 8192, False),
                                        (48, 64, True), (8, 0, False), (3, 50, False),
                                        (5, 33, True)])
    for i in (1, 2):
        g, ids, mask = _unfold_inputs(cuda, 700, 1, 90 + i, seed=40 + i)
        items.append((*items[0][:2], g, ids, mask))
    packed.unfold_rows_scatter_group(items)
    torch.cuda.synchronize()
    assert launch_counts()["unfold_rows"] == 1
    _check_rows_unfold(items)


@pytest.mark.parametrize("n,launches", [(64, 1), (65, 1), (180, 1), (512, 1), (513, 2)])
def test_unfold_rows_group_takes_512_members_a_launch(cuda, n, launches):
    """Up to 512 members a launch in the ~30 KB parameter struct (the
    212-feature ctr's 180 columns: one launch), 513 in two."""
    items = _rows_unfold_members(cuda, [(56 if i % 5 else 8, 40 + 3 * i, i % 11 == 0)
                                        for i in range(n)], rows=300)
    packed.unfold_rows_scatter_group(items)
    torch.cuda.synchronize()
    assert launch_counts()["unfold_rows"] == launches
    _check_rows_unfold(items)


def test_train_step_launches_one_grouped_fold_and_unfold(cuda):
    """A small autoint train step with 5 ids: one K1, one K3 and one K8
    launch; with 1 id no K1 or K3, but one K2 for the single-id segment
    (the 24 small tables share one storage) and one grouped K4 for its 24
    columns."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.train import create_train_state, make_train_step

    bundle = create_model("autoint", bucket_size=256, device="cuda")
    step = make_train_step(bundle)
    for ipf, want in ((5, {"fold_mean": 1, "unfold_mean": 1, "fold_rows": 0,
                           "unfold_rows": 0, "sparse_adam_update": 1}),
                      (1, {"fold_mean": 0, "unfold_mean": 0, "fold_rows": 1,
                           "unfold_rows": 1, "sparse_adam_update": 1})):
        state = create_train_state(bundle, seed=0)
        batch, dense, labels, weight = synthetic_batch(bundle, 64, seed=1,
                                                       ids_per_feature=ipf)
        reset_launch_counts()
        state, info = step(state, batch, labels, weight, dense, seed=0)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert {k: counts[k] for k in want} == want
        assert torch.isfinite(info["loss"])


@pytest.mark.parametrize("rows,d,live", [(265104, 8, 0.3), (1000, 8, 1.0),
                                         (999, 3, 0.5), (300, 40, 0.5), (64, 8, 0.0)])
def test_sparse_adam_kernel(cuda, rows, d, live):
    g = torch.Generator(device=cuda).manual_seed(rows + d)
    cnt = torch.where(torch.rand((rows, 1), generator=g, device=cuda) < live,
                      torch.randint(1, 5, (rows, 1), generator=g, device=cuda),
                      0).float()
    acc = torch.cat([(torch.randn((rows, d), generator=g, device=cuda) * 1e-2
                      * (cnt > 0)).reshape(-1), cnt.reshape(-1)])

    def state():
        gs = torch.Generator(device=cuda).manual_seed(1)
        return {"w": torch.randn((rows, d), generator=gs, device=cuda),
                "opt": {"m": torch.randn((rows, d), generator=gs, device=cuda) * 1e-3,
                        "v": torch.rand((rows, d), generator=gs, device=cuda) * 1e-5,
                        "t": torch.randint(0, 4, (rows, 1), generator=gs,
                                           device=cuda).float()},
                "show": torch.randint(0, 9, (rows, 1), generator=gs,
                                      device=cuda).float()}

    before, got, want = state(), state(), state()
    opt = SparseAdam(learning_rate=1e-3)
    acc_k = acc.clone()
    packed.sparse_adam_update(opt, got, acc_k)
    packed.sparse_adam_update_plain(opt, want, acc.clone())
    torch.cuda.synchronize()
    torch.testing.assert_close(got["w"], want["w"], rtol=0, atol=1e-7)
    for name in ("m", "v"):
        torch.testing.assert_close(got["opt"][name], want["opt"][name], rtol=1e-6, atol=0)
    torch.testing.assert_close(got["opt"]["t"], want["opt"]["t"], rtol=0, atol=0)
    torch.testing.assert_close(got["show"], want["show"], rtol=0, atol=0)
    dead = cnt[:, 0] == 0
    for a, b in ((got["w"], before["w"]), (got["opt"]["m"], before["opt"]["m"]),
                 (got["opt"]["t"], before["opt"]["t"])):
        torch.testing.assert_close(a[dead], b[dead], rtol=0, atol=0)
    assert not acc_k.any()
    assert launch_counts()["sparse_adam_update"] == 1


def _adam_storage(dev, rows, d, live, seed):
    """(state, accumulator) of one storage: a share ``live`` of rows with
    counts 1..4 and gradients, the others all zero; the accumulator flat,
    its gradient block before its counts."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cnt = torch.where(torch.rand((rows, 1), generator=g, device=dev) < live,
                      torch.randint(1, 5, (rows, 1), generator=g, device=dev), 0).float()
    acc = torch.cat([(torch.randn((rows, d), generator=g, device=dev) * 1e-2
                      * (cnt > 0)).reshape(-1), cnt.reshape(-1)])
    state = {"w": torch.randn((rows, d), generator=g, device=dev),
             "opt": {"m": torch.randn((rows, d), generator=g, device=dev) * 1e-3,
                     "v": torch.rand((rows, d), generator=g, device=dev) * 1e-5,
                     "t": torch.randint(0, 4, (rows, 1), generator=g, device=dev).float()},
             "show": torch.randint(0, 9, (rows, 1), generator=g, device=dev).float()}
    return state, acc


def _copy_state(s):
    return {"w": s["w"].clone(), "opt": {n: x.clone() for n, x in s["opt"].items()},
            "show": s["show"].clone()}


@pytest.mark.parametrize("n,live", [(4, 0.0), (4, 0.3), (4, 1.0), (70, 0.3)])
def test_sparse_adam_group_kernel(cuda, n, live):
    """One grouped pass over storages of D 8, 48, 56, 3 and 1 with odd row
    counts (70 storages: more than one launch takes) against the plain
    version on each storage; dead rows bit-identical, accumulators zero."""
    dims = (8, 48, 56, 3, 1)
    storages = [_adam_storage(cuda, 2001 + 37 * i if i < 4 else 5 + i, dims[i % 5], live, i)
                for i in range(n)]
    before = [_copy_state(s) for s, _ in storages]
    got = [_copy_state(s) for s, _ in storages]
    accs = [a.clone() for _, a in storages]
    opt = SparseAdam(learning_rate=1e-3)
    packed.sparse_adam_update_group(opt, got, accs)
    torch.cuda.synchronize()
    assert launch_counts()["sparse_adam_update"] == -(-n // 64)
    for (s, acc), g, b, a in zip(storages, got, before, accs):
        want = _copy_state(s)
        packed.sparse_adam_update_plain(opt, want, acc.clone())
        torch.testing.assert_close(g["w"], want["w"], rtol=0, atol=1e-7)
        for name in ("m", "v"):
            torch.testing.assert_close(g["opt"][name], want["opt"][name], rtol=1e-6, atol=0)
        torch.testing.assert_close(g["opt"]["t"], want["opt"]["t"], rtol=0, atol=0)
        torch.testing.assert_close(g["show"], want["show"], rtol=0, atol=0)
        dead = packed.accumulator_views(acc, s["w"].shape[1])[1][:, 0] == 0
        for x, y in ((g["w"], b["w"]), (g["opt"]["m"], b["opt"]["m"]),
                     (g["opt"]["v"], b["opt"]["v"]), (g["opt"]["t"], b["opt"]["t"]),
                     (g["show"], b["show"])):
            assert torch.equal(x[dead], y[dead])
        assert not a.any()


def _adagrad_storage(dev, rows, d, live, seed):
    """(state, accumulator) of one AdaGrad storage, as ``_adam_storage``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cnt = torch.where(torch.rand((rows, 1), generator=g, device=dev) < live,
                      torch.randint(1, 5, (rows, 1), generator=g, device=dev), 0).float()
    acc = torch.cat([(torch.randn((rows, d), generator=g, device=dev) * 1e-2
                      * (cnt > 0)).reshape(-1), cnt.reshape(-1)])
    state = {"w": torch.rand((rows, d), generator=g, device=dev) * 0.2 - 0.1,
             "opt": {"g2sum": torch.rand((rows, 1), generator=g, device=dev) * 0.4 + 0.1},
             "show": torch.randint(0, 9, (rows, 1), generator=g, device=dev).float()}
    return state, acc


def _check_adagrad(got, want, before, acc0, acc):
    """K9 against its plain version: w atol 1e-6, g2sum rtol 1e-6, show
    exact, rows with count 0 bit-identical, the accumulator left zero."""
    torch.testing.assert_close(got["w"], want["w"], rtol=0, atol=1e-6)
    torch.testing.assert_close(got["opt"]["g2sum"], want["opt"]["g2sum"], rtol=1e-6, atol=0)
    torch.testing.assert_close(got["show"], want["show"], rtol=0, atol=0)
    dead = packed.accumulator_views(acc0, got["w"].shape[1])[1][:, 0] == 0
    for x, y in ((got["w"], before["w"]), (got["opt"]["g2sum"], before["opt"]["g2sum"]),
                 (got["show"], before["show"])):
        assert torch.equal(x[dead], y[dead])
    assert not acc.any()


@pytest.mark.parametrize("n,live", [(5, 0.0), (5, 0.3), (5, 1.0), (65, 0.3)])
def test_sparse_adagrad_group_kernel(cuda, n, live):
    """One grouped K9 pass over storages of D 8, 16, 32 and 48 with odd row
    counts, one with no live row and, in the groups of 5, one empty (65
    storages: two launches), against ``sparse_adagrad_update_plain`` on
    each; then a second pass on the cleared accumulators refilled, as the
    next train step reuses them."""
    from recommendsystem_tpu_torch.embedding.optimizers import SparseAdaGrad

    dims = (8, 16, 32, 48, 32)
    shapes = [(0 if i == 2 and n < 64 else 2001 + 37 * i if i < 5 else 5 + i, dims[i % 5],
               0.0 if i == 3 else live) for i in range(n)]
    launches = -(-sum(1 for r, _, _ in shapes if r) // 64)
    opt = SparseAdaGrad(learning_rate=5e-3)
    got = None
    for rep in range(2):
        storages = [_adagrad_storage(cuda, r, d, lv, 10 * rep + i)
                    for i, (r, d, lv) in enumerate(shapes)]
        if got is None:
            got = [_copy_state(s) for s, _ in storages]
        before = [_copy_state(g) for g in got]
        accs = [a.clone() for _, a in storages]
        reset_launch_counts()
        packed.sparse_adagrad_update_group(opt, got, accs)
        torch.cuda.synchronize()
        assert launch_counts()["sparse_adagrad_update"] == launches
        for (_, acc0), g, b, a in zip(storages, got, before, accs):
            want = _copy_state(b)
            packed.sparse_adagrad_update_plain(opt, want, acc0.clone())
            _check_adagrad(g, want, b, acc0, a)


def test_sparse_adagrad_kernel_unaligned_and_odd_widths(cuda):
    """A storage of D 3 (one float a lane) and one of D 8 whose tables
    start 4 bytes past a 16-byte boundary take the scalar path."""
    from recommendsystem_tpu_torch.embedding.optimizers import SparseAdaGrad

    opt = SparseAdaGrad(learning_rate=0.1)
    for rows, d, offset in ((999, 3, 0), (500, 8, 1)):
        state, acc0 = _adagrad_storage(cuda, rows, d, 0.5, rows)
        buf = torch.zeros(rows * d + offset, device=cuda)
        w = buf[offset:].view(rows, d)
        w.copy_(state["w"])
        got = {"w": w, "opt": {"g2sum": state["opt"]["g2sum"].clone()},
               "show": state["show"].clone()}
        want = _copy_state(state)
        acc = acc0.clone()
        packed.sparse_adagrad_update(opt, got, acc)
        packed.sparse_adagrad_update_plain(opt, want, acc0.clone())
        torch.cuda.synchronize()
        _check_adagrad(got, want, state, acc0, acc)


def test_staytime_train_step_launches(cuda):
    """A small staytime train step: with 5 ids one K1, K2 (the sequences),
    K3, K4 and K9 and three K7; with 1 id no K1 or K3.  Two steps on the
    card stay finite and leave every accumulator zero."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
    from recommendsystem_tpu_torch.train import create_train_state, make_train_step

    bundle = create_model("staytime", cfg=StaytimeConfig(bucket_size=512, seq_max_len=8),
                          deep_hidden_units=(16, 8), device="cuda")
    step = make_train_step(bundle)
    for ipf, want in ((5, {"fold_mean": 1, "fold_rows": 1, "din_pool": 3, "unfold_mean": 1,
                           "unfold_rows": 1, "sparse_adagrad_update": 1}),
                      (1, {"fold_rows": 1, "din_pool": 3, "unfold_rows": 1,
                           "sparse_adagrad_update": 1})):
        state = create_train_state(bundle, seed=0)
        batch, dense, labels, weight = synthetic_batch(bundle, 64, seed=1, ids_per_feature=ipf)
        reset_launch_counts()
        state, info = step(state, batch, labels, weight, dense, seed=0)
        torch.cuda.synchronize()
        assert {k: v for k, v in launch_counts().items() if v} == want
        state, info = step(state, batch, labels, weight, dense, seed=1)
        assert torch.isfinite(info["loss"])
        for skey in bundle.embedding.storage:
            assert not bundle.embedding.accumulator(skey, cuda).any()


def _din_inputs(dev, b, t, h, seed, requires_grad=False):
    """Query and facts as the first H lanes of 2H-lane rows (the model's
    views); row 0 of the mask all 0 over nonzero facts, the last row full."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, 2 * h), generator=g, device=dev)[:, :h]
    f = torch.randn((b, t, 2 * h), generator=g, device=dev)[:, :, :h]
    lens = torch.randint(1, t + 1, (b,), generator=g, device=dev)
    lens[0], lens[-1] = 0, t
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()
    w1 = torch.randn((4 * h, 16), generator=g, device=dev) * 0.2
    b1, w2, b2 = (torch.randn(shape, generator=g, device=dev) * 0.3
                  for shape in ((16,), (16, 1), (1,)))
    args = [q, f, mask, w1, b1, w2, b2]
    if requires_grad:
        for i in (0, 1, 3, 4, 5, 6):
            args[i] = args[i].detach().requires_grad_()
    return args


@pytest.mark.parametrize("b,t,h", [(8, 50, 16), (256, 50, 16), (16384, 50, 16),
                                   (33, 7, 16), (5, 70, 16), (9, 512, 16), (3, 1, 16)])
def test_din_pool_kernel(cuda, b, t, h):
    args = _din_inputs(cuda, b, t, h, seed=b + t)
    assert not args[1].is_contiguous()
    got = din_pool(*args)
    want = din_pool_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    # the all-masked row is the mean of its facts
    torch.testing.assert_close(got[0], args[1][0].mean(dim=0), rtol=0, atol=2e-5)
    assert launch_counts()["din_pool"] == 1


def _gather_inputs(dev, b, t, seed, rows=5000, d=32):
    """Query (the first 16 lanes of 32-lane rows), a (rows, D) table, (B, T)
    ids and mask: ragged lengths, row 0 and every fifth row all masked, the
    last row full, masked entries over random (nonzero) rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, 32), generator=g, device=dev)[:, :16]
    table = torch.randn((rows, d), generator=g, device=dev)
    ids = torch.randint(0, rows, (b, t), generator=g, device=dev, dtype=torch.int32)
    lens = torch.randint(1, t + 1, (b,), generator=g, device=dev)
    lens[::5], lens[-1] = 0, t
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()
    w1 = torch.randn((64, 16), generator=g, device=dev) * 0.2
    b1, w2, b2 = (torch.randn(shape, generator=g, device=dev) * 0.3
                  for shape in ((16,), (16, 1), (1,)))
    return q, table, ids, mask, w1, b1, w2, b2


@pytest.mark.parametrize("b,t,lanes", [(8, 50, (0, 16)), (256, 50, (0, 16)),
                                       (16384, 50, (0, 16)), (33, 7, (16, 32)),
                                       (5, 70, (8, 24)), (9, 512, (0, 16)), (3, 1, (0, 16)),
                                       (100, 200, (0, 16))])
def test_din_pool_gather_kernel(cuda, b, t, lanes):
    """The gathered pool against its plain version (K2's rows, the window,
    then the pool); T 70 takes two load passes, T 200 and 512 fewer warps a
    block and more than 48 KB of shared memory."""
    q, table, ids, mask, *w = _gather_inputs(cuda, b, t, seed=b + t)
    with torch.inference_mode():
        got = din_pool_gather(q, table, ids, mask, lanes, *w)
    want = din_pool_gather_plain(q, table, ids, mask, lanes, *w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    # no live entry: the mean of zero facts, not of the padding rows
    dead = mask.sum(dim=1) == 0
    assert bool(dead.any()) and not got[dead].any()
    assert launch_counts()["din_pool"] == 1


def test_staytime_predict_launches(cuda):
    """A small staytime predict call: with 5 ids one K1 and no K2 (the
    sequences go to K7, which gathers them), with 1 id one K2; three K7
    launches either way; scores equal the CPU plain path's."""
    import numpy as np

    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
    from recommendsystem_tpu_torch.train import create_train_state, make_predict_step
    from recommendsystem_tpu_torch.train.state import TrainState

    cfg = StaytimeConfig(bucket_size=1024, seq_max_len=50)
    bundle = create_model("staytime", cfg=cfg, deep_hidden_units=(16, 8), device=cuda)
    cpu = create_model("staytime", cfg=cfg, deep_hidden_units=(16, 8), device="cpu")
    state = create_train_state(bundle, seed=0)
    cpu_state = TrainState(params={k: v.cpu() for k, v in state.params.items()},
                           opt_state=None,
                           tables={k: {"w": t["w"].cpu()} for k, t in state.tables.items()})
    for ipf, want in ((5, {"fold_mean": 1, "fold_rows": 0, "din_pool": 3}),
                      (1, {"fold_mean": 0, "fold_rows": 1, "din_pool": 3})):
        batch = synthetic_batch(bundle, 300, seed=ipf, ids_per_feature=ipf)[0]
        reset_launch_counts()
        out = make_predict_step(bundle)(state, batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert {k: counts[k] for k in want} == want
        ref = make_predict_step(cpu)(cpu_state, {k: v.to("cpu") for k, v in batch.items()})
        for k in out:
            np.testing.assert_allclose(out[k].cpu().numpy(), ref[k].numpy(),
                                       rtol=1e-5, atol=2e-6, err_msg=k)


def test_din_pool_backward_through_the_function(cuda):
    args = _din_inputs(cuda, 64, 50, 16, seed=3, requires_grad=True)
    do = torch.randn((64, 16), device=cuda)
    wrt = [args[i] for i in (0, 1, 3, 4, 5, 6)]
    got = torch.autograd.grad(din_pool(*args), wrt, do)
    want = torch.autograd.grad(din_pool_plain(*args), wrt, do)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)
    assert launch_counts()["din_pool"] == 1


def test_dinpool_layer_launches_the_kernel(cuda):
    from recommendsystem_tpu_torch.nn import DINPool
    pool = DINPool(16, device=cuda)
    q, f, mask = _din_inputs(cuda, 40, 50, 16, seed=5)[:3]
    with torch.inference_mode():
        got = pool(q, f, mask.bool())
    torch.testing.assert_close(got, din_pool_plain(q, f, mask, pool.w1, pool.b1,
                                                   pool.w2, pool.b2),
                               rtol=0, atol=2e-5)
    assert launch_counts()["din_pool"] == 1


def _interacting_inputs(dev, b, f, seed, d=8, requires_grad=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, f, d), generator=g, device=dev)
    p = {}
    for name in PARAM_NAMES:
        shape = (d, 8) if name.startswith("w") else (8,)
        scale = 0.5 if name.startswith("w") else 0.2
        p[name] = torch.randn(shape, generator=g, device=dev) * scale
    p["gamma"] = p["gamma"] + 1.0
    if requires_grad:
        x.requires_grad_()
        for t in p.values():
            t.requires_grad_()
    return x, p


@pytest.mark.parametrize("b,f,h", [(8, 24, 2), (256, 24, 2), (1000, 40, 2),
                                   (33, 180, 2), (5, 1, 2), (3, 256, 2),
                                   (64, 13, 1), (64, 13, 4), (64, 13, 8), (1, 24, 2)])
def test_interacting_attention_kernel(cuda, b, f, h):
    x, p = _interacting_inputs(cuda, b, f, seed=b * f + h)
    got = interacting_attention(x, p, h, 1e-3)
    want = interacting_attention_plain(x, p, h, 1e-3)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert launch_counts()["interacting_attention"] == 1


@pytest.mark.parametrize("b,f,h", [(37, 180, 2), (9, 256, 2), (21, 180, 1),
                                   (13, 180, 4), (11, 180, 8), (7, 256, 8),
                                   (43, 40, 4), (22, 24, 1)])
def test_interacting_attention_kernel_wide(cuda, b, f, h):
    """K6 at the 212-feature ctr's F = 180 and at F = 256, ragged B (blocks
    of several samples, the last one part full), every head count."""
    x, p = _interacting_inputs(cuda, b, f, seed=b * f + h + 1)
    got = interacting_attention(x, p, h, 1e-3)
    want = interacting_attention_plain(x, p, h, 1e-3)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert launch_counts()["interacting_attention"] == 1


@pytest.mark.parametrize("h", [1, 2, 4])
def test_interacting_attention_kernel_loose_bound(cuda, h):
    """q = k = v = relu(x) (identity projections); fields 0 and 1 hold 50 in
    units 0 and 4 and in units 1 and 5, every other field about 2 there.
    A query of fields 2.. then scores ~72 (base 2) on keys 0 and 1, while
    the kernel's bound on its largest score (the sum over units of q times
    the largest k) is ~144: its sums fall below 2^-64 and it recomputes
    those heads exactly."""
    b, f = 40, 24
    x, p = _interacting_inputs(cuda, b, f, seed=h + 40)
    eye = torch.eye(8, device=cuda)
    for n in ("wq", "wk", "wv"):
        p[n] = eye.clone()
    for n in ("bq", "bk", "bv"):
        p[n] = torch.zeros(8, device=cuda)
    x = x * 0.3
    x[:, 2:, [0, 1, 4, 5]] += 2.0
    x[:, 0] = 0.0
    x[:, 1] = 0.0
    x[:, 0, [0, 4]] = 50.0
    x[:, 1, [1, 5]] = 50.0
    got = interacting_attention(x, p, h, 1e-3)
    want = interacting_attention_plain(x, p, h, 1e-3)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,f", [(256, 24), (33, 180)])
def test_interacting_attention_is_deterministic(cuda, b, f):
    x, p = _interacting_inputs(cuda, b, f, seed=b + f)
    first = interacting_attention(x, p, 2, 1e-3)
    second = interacting_attention(x, p, 2, 1e-3)
    assert torch.equal(first, second)
    assert launch_counts()["interacting_attention"] == 2


def test_interacting_attention_backward_through_the_function(cuda):
    x, p = _interacting_inputs(cuda, 256, 24, seed=11, requires_grad=True)
    do = torch.randn((256, 24, 8), device=cuda)
    wrt = [x] + [p[n] for n in PARAM_NAMES]
    got = torch.autograd.grad(interacting_attention(x, p), wrt, do)
    want = torch.autograd.grad(interacting_attention_plain(x, p, 2, 1e-3), wrt, do)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)
    assert launch_counts()["interacting_attention"] == 1


def test_interacting_layer_launches_the_kernel(cuda):
    from recommendsystem_tpu_torch.nn import InteractingLayer
    layer = InteractingLayer(8, layer_num=2, unit_num=8, head_num=2, use_dropout=True,
                             device=cuda)
    x = torch.randn((300, 24, 8), device=cuda)
    with torch.inference_mode():
        got = layer(x)
        assert launch_counts()["interacting_attention"] == 2
        want = layer.forward_transposed(x)
        assert launch_counts()["field_attention"] == 2
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.randn(2, 5, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="d_head"):
        field_attention(x, x, x)
    q = torch.randn(2, 4, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="rate"):
        field_attention(q, q, q, 0, 1.0)
    table = torch.randn(10, 8, device=cuda)
    with pytest.raises(ValueError):
        packed.fold_rows(table, torch.zeros(4, dtype=torch.int32),
                         torch.ones(4, device=cuda))       # ids on the CPU
    acc = torch.zeros(10 * 9, device=cuda)
    with pytest.raises(ValueError):
        packed.unfold_rows_scatter(*packed.accumulator_views(acc, 8),
                                   torch.ones(4, 8, device=cuda),
                                   torch.zeros(4, dtype=torch.int32),
                                   torch.ones(4, device=cuda))
    q, f, mask, w1, b1, w2, b2 = _din_inputs(cuda, 4, 6, 16, seed=1)
    with pytest.raises(ValueError, match="T <="):
        din_pool(q, torch.zeros(4, 513, 16, device=cuda), torch.ones(4, 513, device=cuda),
                 w1, b1, w2, b2)
    with pytest.raises(ValueError, match="H 16"):
        din_pool(q[:, :8], f[:, :, :8], mask, w1[:32], b1, w2, b2)
    q, table, ids, mask, *w = _gather_inputs(cuda, 4, 6, seed=2)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="T <="):
            din_pool_gather(q, table, torch.zeros(4, 513, dtype=torch.int32, device=cuda),
                            torch.ones(4, 513, device=cuda), (0, 16), *w)
        with pytest.raises(ValueError):                       # ids on the CPU
            din_pool_gather(q, table, ids.cpu(), mask, (0, 16), *w)
        with pytest.raises(ValueError, match="more than one device"):   # query on the CPU
            din_pool_gather(q.cpu(), table, ids, mask, (0, 16), *w)
        with pytest.raises(ValueError, match="aligned"):
            shifted = torch.cat([torch.zeros(1, device=cuda), table.reshape(-1)])[1:]
            din_pool_gather(q, shifted.view(table.shape), ids, mask, (0, 16), *w)
    with pytest.raises(ValueError, match="members on"):
        packed.fold_rows_group([(table, ids.reshape(-1), mask.reshape(-1)),
                                (table.cpu(), ids.reshape(-1).cpu(), mask.reshape(-1).cpu())])
    from recommendsystem_tpu_torch.nn import DINPool
    with pytest.raises(ValueError, match="width 16"):
        DINPool(16, hidden=8, device=cuda)(q, f, mask.bool())
    x, p = _interacting_inputs(cuda, 4, 24, seed=2, d=16)
    with pytest.raises(ValueError, match="D = U = 8"):
        interacting_attention(x, p)
    x, p = _interacting_inputs(cuda, 2, 257, seed=3)
    with pytest.raises(ValueError, match="F <= 256"):
        interacting_attention(x, p)
    with pytest.raises(ValueError, match="aligned"):
        interacting_attention(x.reshape(-1)[1:1 + 2 * 24 * 8].reshape(2, 24, 8), p)
    wide, wide_acc = _adam_storage(cuda, 1, 1 << 23, 1.0, 0)     # 2^23 x 256 rows > 2^31
    with pytest.raises(ValueError, match="D 8388608"):
        packed.sparse_adam_update(SparseAdam(), wide, wide_acc)
    assert set(launch_counts().values()) == {0}


# -- bf16 tables and moments (ROADMAP.md item 10a) ---------------------------

def _assert_bf16(got, want, want_f32, atol, rtol, what=""):
    """A kernel's stored bf16 entries against its plain version's: equal, or
    one bf16 ulp apart where the plain version's float32 value before
    rounding (``want_f32``, from a float32 copy of the same update) lies
    within ``atol + rtol |x|`` (the float32 tolerance of the kernel's value)
    of the midpoint between the two: either side may round either way
    there.  Returns the number of such entries."""
    assert got.dtype == want.dtype == torch.bfloat16, what
    differ = got != want
    if not bool(differ.any()):
        return 0
    g, w, p = (x[differ].double() for x in (got.float(), want.float(), want_f32.float()))
    bits = lambda x: x.float().view(torch.int32).to(torch.int64) >> 16   # noqa: E731
    adjacent = (torch.sign(g) == torch.sign(w)) & ((bits(g) - bits(w)).abs() == 1)
    assert bool(adjacent.all()), f"{what}: entries more than one bf16 ulp apart"
    near = (p - (g + w) / 2).abs() <= atol + rtol * p.abs()
    assert bool(near.all()), f"{what}: {int((~near).sum())} one-ulp entries off a midpoint"
    return int(differ.sum())


def _as(tstate, w_dtype, m_dtype=None):
    """A copy of a storage's state with w (and Adam's m and v) in the given
    types, rounded to nearest even."""
    out = _copy_state(tstate)
    out["w"] = out["w"].to(w_dtype)
    if m_dtype is not None:
        for name in ("m", "v"):
            out["opt"][name] = out["opt"][name].to(m_dtype)
    return out


BF16_FOLD_MEMBERS = [(8, 5, 300, False), (16, 2, 77, False), (32, 10, 129, False),
                     (48, 7, 64, True), (56, 3, 1, False), (3, 4, 50, False),
                     (32, 5, 4097, False)]


@pytest.mark.parametrize("mixed", [False, True])
def test_fold_mean_group_kernel_bf16(cuda, mixed):
    """K1 over bf16 tables (D 8-56: 8 lanes in 16 bytes; D 3: one lane), in
    one launch, each member against its plain version; ``mixed`` puts
    float32 and bf16 members in one group."""
    items = [(t.to(torch.bfloat16) if not mixed or i % 2 else t, *rest)
             for i, (t, *rest) in enumerate(_fold_members(cuda, BF16_FOLD_MEMBERS))]
    got = packed.fold_mean_group(items)
    torch.cuda.synchronize()
    assert launch_counts()["fold_mean"] == 1
    for out, item in zip(got, items):
        assert out.dtype == torch.float32
        _assert_fold(out, item)


@pytest.mark.parametrize("mixed", [False, True])
def test_fold_rows_group_kernel_bf16(cuda, mixed):
    """K2 over bf16 tables, one launch, each member equal to its plain
    version (the widening is exact, one product per output)."""
    items = [(t.to(torch.bfloat16) if not mixed or i % 2 else t, ids, mask)
             for i, (t, ids, mask) in enumerate(_rows_members(cuda, ROWS_MEMBERS))]
    got = packed.fold_rows_group(items)
    torch.cuda.synchronize()
    assert launch_counts()["fold_rows"] == 1
    _assert_rows(got, items)


def test_fold_rows_group_unaligned_bf16_table(cuda):
    """A bf16 table whose rows are not 16-byte aligned takes one lane a
    thread."""
    flat = _table(cuda, 501, 8, 7).reshape(-1).to(torch.bfloat16)
    table = flat[1:4001].view(500, 8)
    ((_, ids, mask),) = _rows_members(cuda, [(8, 333, False)], rows=500)
    (got,) = packed.fold_rows_group([(table, ids, mask)])
    _assert_rows([got], [(table, ids, mask)])


@pytest.mark.parametrize("b,t,lanes", [(8, 50, (0, 16)), (256, 50, (0, 16)),
                                       (16384, 50, (0, 16)), (33, 7, (16, 32)),
                                       (5, 70, (8, 24)), (9, 512, (0, 16))])
def test_din_pool_gather_kernel_bf16(cuda, b, t, lanes):
    """K7's gathering entry over a bf16 (rows, 32) table against its plain
    version (the widened rows, the window, the pool)."""
    q, table, ids, mask, *w = _gather_inputs(cuda, b, t, seed=b + t + 1)
    table = table.to(torch.bfloat16)
    with torch.inference_mode():
        got = din_pool_gather(q, table, ids, mask, lanes, *w)
    want = din_pool_gather_plain(q, table, ids, mask, lanes, *w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    dead = mask.sum(dim=1) == 0
    assert bool(dead.any()) and not got[dead].any()
    assert launch_counts()["din_pool"] == 1


@pytest.mark.parametrize("w_dtype,m_dtype", [(torch.bfloat16, torch.float32),
                                             (torch.bfloat16, torch.bfloat16),
                                             (torch.float32, torch.bfloat16)])
def test_sparse_adam_group_kernel_bf16(cuda, w_dtype, m_dtype):
    """K8 over bf16 w and/or bf16 moments, storages of D 8, 48, 56, 3 and 1
    in one launch (plus a float32 one in the same group), against the plain
    version: stored bf16 entries by ``_assert_bf16`` (w atol 1e-7, m and v
    rtol 1e-6), t and show exact, dead rows bit-identical, accumulators
    zero."""
    dims = (8, 48, 56, 3, 1)
    storages = [_adam_storage(cuda, 2001 + 37 * i, dims[i], 0.3, i) for i in range(5)]
    storages.append(_adam_storage(cuda, 999, 8, 0.3, 9))
    kinds = [(w_dtype, m_dtype)] * 5 + [(torch.float32, torch.float32)]
    got = [_as(s, *k) for (s, _), k in zip(storages, kinds)]
    before = [_copy_state(g) for g in got]
    accs = [a.clone() for _, a in storages]
    opt = SparseAdam(learning_rate=1e-3, state_dtype=m_dtype)
    packed.sparse_adam_update_group(opt, got, accs)
    torch.cuda.synchronize()
    assert launch_counts()["sparse_adam_update"] == 1
    for (s, acc), g, b, a, (wd, md) in zip(storages, got, before, accs, kinds):
        want = _copy_state(b)
        packed.sparse_adam_update_plain(SparseAdam(learning_rate=1e-3, state_dtype=md), want,
                                        acc.clone())
        twin = _as(b, torch.float32, torch.float32)
        packed.sparse_adam_update_plain(SparseAdam(learning_rate=1e-3), twin, acc.clone())
        assert g["w"].dtype == wd and g["opt"]["m"].dtype == md
        if wd == torch.bfloat16:
            _assert_bf16(g["w"], want["w"], twin["w"], 1e-7, 0.0, "w")
        else:
            torch.testing.assert_close(g["w"], want["w"], rtol=0, atol=1e-7)
        for name in ("m", "v"):
            if md == torch.bfloat16:
                _assert_bf16(g["opt"][name], want["opt"][name], twin["opt"][name], 0.0, 1e-6,
                             name)
            else:
                torch.testing.assert_close(g["opt"][name], want["opt"][name], rtol=1e-6,
                                           atol=0)
        torch.testing.assert_close(g["opt"]["t"], want["opt"]["t"], rtol=0, atol=0)
        torch.testing.assert_close(g["show"], want["show"], rtol=0, atol=0)
        dead = packed.accumulator_views(acc, s["w"].shape[1])[1][:, 0] == 0
        for x, y in ((g["w"], b["w"]), (g["opt"]["m"], b["opt"]["m"]),
                     (g["opt"]["v"], b["opt"]["v"])):
            assert torch.equal(x[dead], y[dead])
        assert not a.any()


def test_sparse_adagrad_group_kernel_bf16(cuda):
    """K9 over bf16 w, storages of D 8, 16, 32, 48 and 3 and a float32 one
    in one launch, against the plain version: w by ``_assert_bf16`` (atol
    1e-6), g2sum rtol 1e-6, show exact, dead rows bit-identical."""
    from recommendsystem_tpu_torch.embedding.optimizers import SparseAdaGrad

    dims = (8, 16, 32, 48, 3, 32)
    storages = [_adagrad_storage(cuda, 2001 + 37 * i, d, 0.3, i) for i, d in enumerate(dims)]
    got = [_as(s, torch.bfloat16 if i < 5 else torch.float32)
           for i, (s, _) in enumerate(storages)]
    before = [_copy_state(g) for g in got]
    accs = [a.clone() for _, a in storages]
    opt = SparseAdaGrad(learning_rate=5e-3)
    packed.sparse_adagrad_update_group(opt, got, accs)
    torch.cuda.synchronize()
    assert launch_counts()["sparse_adagrad_update"] == 1
    for (_, acc0), g, b, a in zip(storages, got, before, accs):
        want = _copy_state(b)
        packed.sparse_adagrad_update_plain(opt, want, acc0.clone())
        if g["w"].dtype == torch.bfloat16:
            twin = _as(b, torch.float32)
            packed.sparse_adagrad_update_plain(opt, twin, acc0.clone())
            _assert_bf16(g["w"], want["w"], twin["w"], 1e-6, 0.0, "w")
            want["w"] = g["w"]        # held above; the rest as float32 storages are
        _check_adagrad(g, want, b, acc0, a)


# -- the bf16 compute policy: K5f, K5b, K6 and K7 on bf16 inputs -------------
#
# Each kernel widens its bf16 inputs exactly and computes in float32, so its
# float32 outputs keep the float32 tolerances against the plain version on
# the same bf16 inputs; a bf16 output (K5b's dq, dk, dv) is the float32
# value rounded once on each side, so it may sit one bf16 ulp (2^-7
# relative at most) from the plain version's where that float32 value lies
# within the float32 tolerance of a rounding midpoint.

BF16 = torch.bfloat16
BF16_GRAD_TOL = dict(rtol=2.0 ** -7 + 1e-4, atol=2e-5)


@pytest.mark.parametrize("x_dtype", [BF16, torch.float32])
@pytest.mark.parametrize("b,f,h", [(8, 24, 2), (1000, 40, 2), (33, 180, 2), (64, 13, 1),
                                   (64, 13, 8), (5, 256, 4)])
def test_interacting_attention_kernel_bf16(cuda, b, f, h, x_dtype):
    """K6 on bf16 parameters with bf16 x (a first iteration) and with
    float32 x (a later one), against the plain version."""
    x, p = _interacting_inputs(cuda, b, f, seed=b * f + h + 7)
    x = x.to(x_dtype)
    p = {n: t.to(BF16) for n, t in p.items()}
    got = interacting_attention(x, p, h, 1e-3)
    want = interacting_attention_plain(x, p, h, 1e-3)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert launch_counts()["interacting_attention"] == 1


def test_interacting_attention_backward_bf16(cuda):
    x, p = _interacting_inputs(cuda, 256, 24, seed=12)
    x = x.to(BF16).requires_grad_()
    p = {n: t.to(BF16).requires_grad_() for n, t in p.items()}
    do = torch.randn((256, 24, 8), device=cuda)
    wrt = [x] + [p[n] for n in PARAM_NAMES]
    got = torch.autograd.grad(interacting_attention(x, p), wrt, do)
    want = torch.autograd.grad(interacting_attention_plain(x, p, 2, 1e-3), wrt, do)
    for a, w in zip(got, want):
        assert a.dtype == BF16
        torch.testing.assert_close(a, w, rtol=0, atol=0)     # one plain recompute
    assert launch_counts()["interacting_attention"] == 1


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("h,dh,f,b", [(2, 4, 24, 200), (2, 4, 175, 256), (1, 8, 40, 33),
                                      (2, 4, 24, 4500), (2, 32, 9, 64), (3, 2, 1, 5)])
def test_field_attention_fwd_kernel_bf16(cuda, h, dh, f, b, rate):
    """K5f on bf16 q, k, v (the chunks staged by plain loads) with its lse,
    against the plain version: float32 o and lse, the same dropout mask."""
    g = torch.Generator(device=cuda).manual_seed(f * b + 3)
    q, k, v = (torch.randn((h, dh, f, b), generator=g, device=cuda).to(BF16)
               for _ in range(3))
    seed = (77 << 32) | 1
    q.requires_grad_()
    o = field_attention(q, k, v, seed, rate)       # K5f with its lse
    want_o, want_lse = field_attention_fwd_plain(q.detach(), k, v, seed, rate)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32
    torch.testing.assert_close(o, want_o, rtol=0, atol=2e-5)
    with torch.no_grad():
        torch.testing.assert_close(field_attention(q, k, v, seed, rate), want_o,
                                   rtol=0, atol=2e-5)
    assert launch_counts()["field_attention"] == 2
    assert want_lse.dtype == torch.float32


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("h,dh,f,b", [(2, 4, 24, 200), (2, 4, 175, 96), (1, 8, 40, 33),
                                      (1, 4, 256, 33), (2, 32, 9, 64), (1, 16, 30, 45)])
def test_field_attention_bwd_kernel_bf16(cuda, h, dh, f, b, rate):
    """K5b on bf16 q, k, v with float32 o, lse and do: bf16 dq, dk, dv
    against the plain version's, one rounding each (F 175, 256 and 40 at dh
    8 sum dq over several key chunks in the float32 scratch)."""
    g = torch.Generator(device=cuda).manual_seed(f * b + 5)
    q, k, v = (torch.randn((h, dh, f, b), generator=g, device=cuda).to(BF16)
               for _ in range(3))
    do = torch.randn((h, dh, f, b), generator=g, device=cuda)
    o, lse = field_attention_fwd_plain(q, k, v, 9, rate)
    got = field_attention_bwd(q, k, v, o, lse, do, 9, rate)
    want = field_attention_bwd_reference(q, k, v, o, lse, do, 9, rate)
    again = field_attention_bwd(q, k, v, o, lse, do, 9, rate)
    torch.cuda.synchronize()
    for a, w, a2 in zip(got, want, again):
        assert a.dtype == w.dtype == BF16
        torch.testing.assert_close(a.float(), w.float(), **BF16_GRAD_TOL)
        assert torch.equal(a, a2)
    assert launch_counts()["field_attention_bwd"] == 2


def _din_inputs_bf16(dev, b, t, seed):
    """``_din_inputs`` in bf16: query and facts as the first 16 lanes of
    bf16 32-lane rows, the scorer in bf16, the mask float32."""
    q, f, mask, *w = _din_inputs(dev, b, t, 16, seed)
    return [_bf16_lanes(q), _bf16_lanes(f), mask, *(x.to(BF16) for x in w)]


def _bf16_lanes(x):
    """``x`` (the first 16 lanes of 32-lane rows) in bf16, as the first 16
    lanes of bf16 rows of 32."""
    rows = torch.zeros(*x.shape[:-1], 2 * x.shape[-1], dtype=BF16, device=x.device)
    rows[..., :x.shape[-1]] = x
    return rows[..., :x.shape[-1]]


@pytest.mark.parametrize("b,t", [(8, 50), (16384, 50), (33, 7), (5, 70), (9, 512), (3, 1)])
def test_din_pool_kernel_bf16(cuda, b, t):
    """K7 with its facts given, on bf16 inputs: the bf16 roundings of q - f
    and q * f, then float32, against the plain version."""
    args = _din_inputs_bf16(cuda, b, t, seed=b + t + 3)
    assert not args[1].is_contiguous()
    got = din_pool(*args)
    want = din_pool_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    torch.testing.assert_close(got[0], args[1][0].float().mean(dim=0), rtol=0, atol=2e-5)
    assert launch_counts()["din_pool"] == 1


def test_din_pool_backward_bf16(cuda):
    args = _din_inputs_bf16(cuda, 256, 50, seed=4)
    for i in (0, 1, 3, 4, 5, 6):
        args[i] = args[i].detach().requires_grad_()
    wrt = [args[i] for i in (0, 1, 3, 4, 5, 6)]
    do = torch.randn((256, 16), device=cuda)
    got = torch.autograd.grad(din_pool(*args), wrt, do)
    want = torch.autograd.grad(din_pool_plain(*args), wrt, do)
    for a, w in zip(got, want):
        assert a.dtype == BF16
        torch.testing.assert_close(a, w, rtol=0, atol=0)     # one plain recompute
    assert launch_counts()["din_pool"] == 1


@pytest.mark.parametrize("table_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("b,t,lanes", [(8, 50, (0, 16)), (16384, 50, (0, 16)),
                                       (33, 7, (16, 32)), (5, 70, (8, 24)), (9, 512, (0, 16))])
def test_din_pool_gather_kernel_bf16_compute(cuda, b, t, lanes, table_dtype):
    """K7's gathering entry under the bf16 compute policy: bf16 query and
    scorer, facts from a float32 table (rounded to bf16 as they are read)
    or a bf16 one, against the plain version."""
    q, table, ids, mask, *w = _gather_inputs(cuda, b, t, seed=b + t + 2)
    q = _bf16_lanes(q)
    w = [x.to(BF16) for x in w]
    table = table.to(table_dtype)
    with torch.inference_mode():
        got = din_pool_gather(q, table, ids, mask, lanes, *w, facts_dtype=BF16)
    want = din_pool_gather_plain(q, table, ids, mask, lanes, *w, facts_dtype=BF16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    dead = mask.sum(dim=1) == 0
    assert bool(dead.any()) and not got[dead].any()
    assert launch_counts()["din_pool"] == 1


def test_bf16_layers_launch_their_kernels(cuda):
    """Under the policy the InteractingLayer serves through K6 and trains
    through K5f and K5b on bf16 q, k, v, and DINPool pools through K7."""
    from torch.func import functional_call

    from recommendsystem_tpu_torch.nn import DINPool, InteractingLayer
    layer = InteractingLayer(8, layer_num=2, unit_num=8, head_num=2, use_dropout=True,
                             device=cuda)
    params = {k: p.detach().to(BF16) for k, p in layer.named_parameters()}
    x = torch.randn((300, 24, 8), device=cuda).to(BF16)
    with torch.inference_mode():
        got = functional_call(layer, params, (x,))
    assert got.dtype == torch.float32 and launch_counts()["interacting_attention"] == 2
    out = functional_call(layer, {k: p.requires_grad_() for k, p in params.items()},
                          (x.requires_grad_(),), {"training": True, "seed": 3})
    out.sum().backward()
    counts = launch_counts()
    assert counts["field_attention"] == counts["field_attention_bwd"] == 2
    assert x.grad.dtype == BF16
    pool = DINPool(16, device=cuda)
    pparams = {k: p.detach().to(BF16) for k, p in pool.named_parameters()}
    q, f, _, *_ = _din_inputs_bf16(cuda, 64, 50, seed=1)
    with torch.inference_mode():
        assert functional_call(pool, pparams, (q, f)).dtype == torch.float32
    assert launch_counts()["din_pool"] == 1


@pytest.mark.parametrize("a_shape,b_shape", [((300, 48), (48, 64)), ((7, 300, 48), (48, 64)),
                                             ((300, 48), (3, 48, 16)),
                                             ((3, 300, 48), (3, 48, 16))])
def test_bf16_products_with_a_float32_result(cuda, a_shape, b_shape):
    """``nn.dot_f32`` on two bf16 CUDA operands (the tensor cores, float32
    accumulation and result) against the widened float32 product, and its
    gradients (the widened product's, rounded once to bf16)."""
    from recommendsystem_tpu_torch.nn import dot_f32
    a = torch.randn(a_shape, device=cuda).to(BF16).requires_grad_()
    b = torch.randn(b_shape, device=cuda).to(BF16).requires_grad_()
    got = dot_f32(a, b)
    want = a.float() @ b.float()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    g = torch.randn(want.shape, device=cuda)
    ga, gb = torch.autograd.grad(got, (a, b), g)
    wa, wb = torch.autograd.grad(want, (a, b), g)
    for x, w in ((ga, wa), (gb, wb)):
        assert x.dtype == BF16
        torch.testing.assert_close(x.float(), w.float(), **BF16_GRAD_TOL)


# -- the forward kernels as custom ops (kernels/_ops.py) ---------------------

def _op_cases(dev):
    """(op, args, the plain version's output(s), kernel, tolerance) for each
    of the custom ops, at the predict path's shapes; K1's members in place
    of its outputs, held by ``_assert_fold``."""
    from recommendsystem_tpu_torch.kernels import _ops
    means = _fold_members(dev, [(8, 5, 256, False), (32, 5, 300, False), (16, 3, 77, True)])
    rows = _rows_members(dev, [(8, 256, False), (32, 1000, False), (5, 33, True)])
    q, f, mask, *w = _din_inputs(dev, 256, 50, 16, seed=5)
    gq, table, ids, gmask, *gw = _gather_inputs(dev, 256, 50, seed=6)
    x, p = _interacting_inputs(dev, 256, 24, seed=7)
    g = torch.Generator(device=dev).manual_seed(8)
    qkv = [torch.randn((2, 4, 24, 256), generator=g, device=dev) for _ in range(3)]
    seed = (77 << 32) | 3
    tables, fids, fmasks, cs, ls = (list(t) for t in zip(*means))
    rt, ri, rm = (list(t) for t in zip(*rows))
    return [
        ("fold_mean_group", (tables, fids, fmasks, cs, ls), means, "fold_mean", None),
        ("fold_rows_group", (rt, ri, rm), [packed.fold_rows_plain(*m) for m in rows],
         "fold_rows", 0.0),
        ("din_pool", (q, f, mask, *w), din_pool_plain(q, f, mask, *w), "din_pool", 2e-5),
        ("din_pool_gather", (gq, table, ids, gmask, 0, 16, *gw, torch.float32),
         din_pool_gather_plain(gq, table, ids, gmask, (0, 16), *gw), "din_pool", 2e-5),
        ("interacting_attention", (x, *(p[n] for n in PARAM_NAMES), 2, 1e-3),
         interacting_attention_plain(x, p, 2, 1e-3), "interacting_attention", 2e-5),
        ("field_attention_fwd", (*qkv, _ops.signed_seed(seed), 0.2, True),
         list(field_attention_fwd_plain(*qkv, seed, 0.2)), "field_attention", 2e-5),
    ]


def test_custom_ops_launch_their_kernels(cuda):
    """Each forward kernel called through ``torch.ops.recommendsystem_tpu_torch``
    equals its plain version on the card, and counts one launch a call."""
    for name, args, want, kernel, atol in _op_cases(cuda):
        reset_launch_counts()
        got = getattr(torch.ops.recommendsystem_tpu_torch, name)(*args)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts[kernel] == 1 and sum(counts.values()) == 1, (name, counts)
        got = list(got) if isinstance(got, (list, tuple)) else [got]
        want = want if isinstance(want, list) else [want]
        assert len(got) == len(want), name
        for gv, wv in zip(got, want):
            if atol is None:       # K1: the grouped folds' tolerance
                _assert_fold(gv, wv)
            else:
                torch.testing.assert_close(gv, wv, rtol=0, atol=atol, msg=name)


@pytest.mark.parametrize("sample0", [1, 65541, (1 << 32) - 7])
@pytest.mark.parametrize("f,b", [(24, 300), (40, 77)])
def test_field_attention_sample_offset(cuda, f, b, sample0):
    """K5f and K5b draw the dropout of a rank's rows from their first
    global sample (``sample0``, wrapping at 2**32), as the plain versions
    do: the sharded step's masks are the local step's."""
    g = torch.Generator(device=cuda).manual_seed(f + b + sample0 % 97)
    q, k, v, do = (torch.randn((2, 4, f, b), generator=g, device=cuda) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = field_attention(*leaves, 5, 0.2, sample0=sample0)
    o.backward(do)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = field_attention_reference(*plain, 5, 0.2, sample0)
    want.backward(do)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, want, rtol=0, atol=2e-5)
    for a, w in zip(leaves, plain):
        torch.testing.assert_close(a.grad, w.grad, rtol=1e-4, atol=2e-5)
    assert not torch.equal(want, field_attention_reference(q, k, v, 5, 0.2, 0))
    assert launch_counts()["field_attention"] == 1
    assert launch_counts()["field_attention_bwd"] == 1
