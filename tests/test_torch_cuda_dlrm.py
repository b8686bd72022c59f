"""DLRM-DCNv2's kernels on the card: K10 against its plain version, the
low-rank cross net on the card against the CPU, and K1, K3 and K9 at D 128,
L 100 over a table of 10 M rows (against their 32-bit indexing: a member's
offsets reach 10 M x 129 floats of its accumulator).

Every test carries the ``cuda`` marker and skips without a card.  The file
imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_dlrm.py

Tolerances: K10's du and x0's gradient exact (the kernel rounds each
product and sum once, in the plain version's order), db's partial sums
atol 1e-4 (32 rows in another order); the cross net atol 1e-4 on its
output and gradients against the CPU (cuBLAS sums 3,456 terms in another
order); K1 atol 1e-5 (100 products summed in another order); K3's
gradient sums atol 1e-4 (a hot row sums thousands of entries in another
order on every run), its counts exact; K9's w atol 1e-6 and g2sum rtol
1e-6, rows with count 0 bit-identical.
"""

import pytest
import torch

from recommendsystem_tpu_torch.embedding import packed
from recommendsystem_tpu_torch.embedding.optimizers import SparseAdaGrad
from recommendsystem_tpu_torch.kernels import dcn_cross, launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.nn import LowRankCrossNet

pytestmark = pytest.mark.cuda

BIG_ROWS = 10_000_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()
    return torch.device("cuda")


@pytest.mark.parametrize("rows,f", [(16384, 3456), (77, 10), (33, 3456)])
@pytest.mark.parametrize("accumulate,residual", [(False, False), (True, False), (True, True)])
def test_dcn_cross_kernel_matches_plain(cuda, rows, f, accumulate, residual):
    gen = torch.Generator(device=cuda).manual_seed(rows + f)
    g, x0, u, dx0 = torch.randn((4, rows, f), generator=gen, device=cuda).unbind(0)
    g, x0, u, dx0 = (t.contiguous() for t in (g, x0, u, dx0))
    plain_dx0 = dx0.cpu()
    du, partial = dcn_cross.dcn_cross_bwd(g, x0, u, dx0, accumulate, residual)
    want_du, want_partial = dcn_cross.dcn_cross_bwd_plain(g.cpu(), x0.cpu(), u.cpu(),
                                                          plain_dx0, accumulate, residual)
    assert launch_counts()["dcn_cross"] == 1
    assert torch.equal(du.cpu(), want_du) and torch.equal(dx0.cpu(), plain_dx0)
    torch.testing.assert_close(partial.cpu(), want_partial, rtol=0, atol=1e-4)


def test_cross_net_on_the_card_matches_the_cpu(cuda):
    torch.manual_seed(0)
    net = LowRankCrossNet(3456, 512, 3)
    with torch.no_grad():
        for p in net.parameters():
            if p.ndim == 1:
                p.uniform_(-0.05, 0.05)
    x = torch.randn((256, 3456)) * 0.3
    g = torch.randn((256, 3456))
    outs = []
    for dev in ("cpu", cuda):
        m = LowRankCrossNet(3456, 512, 3, device=dev)
        m.load_state_dict(net.state_dict())
        xi = x.to(dev).requires_grad_()
        out = m(xi)
        grads = torch.autograd.grad(out, [xi, *m.parameters()], g.to(dev))
        outs.append([out.detach().cpu()] + [t.cpu() for t in grads])
    assert launch_counts()["dcn_cross"] == 3
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


def test_wide_kernels_over_a_ten_million_row_table(cuda):
    """K1 at L 100 and B 16384, K3 over the same ids, then K9, over a
    (10 M, 128) table whose last row is read and written."""
    d, l, b = 128, 100, 16384
    gen = torch.Generator(device=cuda).manual_seed(7)
    w = torch.empty((BIG_ROWS, d), device=cuda).uniform_(-0.05, 0.05, generator=gen)
    ids = torch.randint(0, BIG_ROWS, (l * b,), generator=gen, device=cuda, dtype=torch.int32)
    ids[:5] = BIG_ROWS - 1                               # the last row, and a hot one
    ids[5:4000] = 123
    mask = (torch.rand((l * b,), generator=gen, device=cuda) < 0.9).float()
    # K1: sums over the 100 slots of each row (l-major)
    (got,) = packed.fold_mean_group([(w, ids, mask, 1, l)])
    want = (w[ids.long()] * mask[:, None]).reshape(l, b, d).sum(0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    # K3: each live slot's row gradient and a count of 1 into the accumulator
    acc = torch.zeros(BIG_ROWS * (d + 1), device=cuda)
    grads, counts = packed.accumulator_views(acc, d)
    g = torch.randn((b, d), generator=gen, device=cuda) * 1e-3
    packed.unfold_mean_scatter_group([(grads, counts, g, ids, mask, l)])
    live = mask > 0
    uniq, inv = torch.unique(ids[live].long(), return_inverse=True)
    want_g = torch.zeros((uniq.shape[0], d), device=cuda).index_add_(
        0, inv, g.repeat(l, 1)[live])
    want_n = torch.zeros((uniq.shape[0], 1), device=cuda).index_add_(
        0, inv, torch.ones((inv.shape[0], 1), device=cuda))
    torch.testing.assert_close(grads[uniq], want_g, rtol=0, atol=1e-4)
    assert torch.equal(counts[uniq], want_n) and float(counts.sum()) == float(live.sum())
    # K9 over the storage: the live rows step, the others stay bit-identical
    opt = SparseAdaGrad(learning_rate=0.005, initial_g2sum=1e-16)
    tstate = {"w": w, "opt": opt.init_state((BIG_ROWS, d), cuda),
              "show": torch.zeros((BIG_ROWS, 1), device=cuda)}
    gl = grads[uniq].clone()
    w_live = w[uniq].clone()
    dead = torch.randint(0, BIG_ROWS, (4096,), generator=gen, device=cuda)
    dead = dead[counts[dead, 0] == 0]
    w_dead = w[dead].clone()
    packed.sparse_adagrad_update_group(opt, [tstate], [acc])
    g2 = 1e-16 + torch.square(gl).mean(dim=-1, keepdim=True)
    torch.testing.assert_close(tstate["opt"]["g2sum"][uniq], g2, rtol=1e-6, atol=0)
    torch.testing.assert_close(w[uniq], w_live - 0.005 * gl / torch.sqrt(g2), rtol=0,
                               atol=1e-6)
    assert torch.equal(tstate["show"][uniq], want_n) and torch.equal(w[dead], w_dead)
    assert float(acc.abs().max()) == 0.0
    assert {k: v for k, v in launch_counts().items() if v} == {
        "fold_mean": 1, "unfold_mean": 1, "sparse_adagrad_update": 1}
