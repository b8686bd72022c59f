"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker, needs a CUDA card and skips
without one (the ``cuda`` fixture decides, at run time).  The file imports
no JAX, so it also runs where JAX is absent, without the suite's conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: folds atol 1e-6 (sums of <= 5 float32 products in another
order); attention atol 2e-5 (softmax over <= 175 keys in another order).
"""

import pytest
import torch

from recommendsystem_tpu_torch.embedding import packed
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.kernels.field_attention import (
    field_attention,
    field_attention_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
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


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn(2, 4, 8, 16, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="slice 2"):
        field_attention(q, q, q)
    x = torch.randn(2, 5, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="d_head"):
        field_attention(x, x, x)
    table = torch.randn(10, 8, device=cuda)
    with pytest.raises(ValueError):
        packed.fold_rows(table, torch.zeros(4, dtype=torch.int32),
                         torch.ones(4, device=cuda))       # ids on the CPU
    assert launch_counts() == {"fold_mean": 0, "fold_rows": 0,
                               "field_attention": 0}
