"""Port parity for K5, field attention: the forward (K5f), the backward
(K5b) and dropout on the attention weights.

The JAX kernel runs in Pallas interpret mode on the CPU, as
``tests/test_kernels.py`` runs it, at rate 0: its in-kernel random bits
have no CPU lowering, and no port could draw the TPU's bits.  Dropout is
held instead to the Philox4x32-10 known answers, to the keep rate, and to
finite differences through the plain forward.  Tolerances: forward rtol =
atol = 1e-5 (softmax over at most 175 keys and a 4-term contraction in
float32, summed in another order than the JAX kernel's); gradients rtol
1e-4, atol 1e-5, as ``tests/test_kernels.py`` holds the JAX kernel's
backward to its reference."""

import numpy as np
import pytest
import torch

from recommendsystem_tpu.kernels.field_attention_pallas import (
    field_attention as jax_field_attention,
    field_attention_reference as jax_field_attention_reference,
)
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.kernels.field_attention import (
    dropout_scale,
    field_attention,
    field_attention_bwd,
    field_attention_bwd_reference,
    field_attention_fwd_plain,
    field_attention_reference,
    philox4x32_10,
)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _qkv(h, dh, f, b, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((h, dh, f, b)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("f", [11, 24])
def test_matches_jax_kernel_interpret(f):
    q, k, v = _qkv(2, 4, f, 128, seed=f)
    want = jax_field_attention(q, k, v, 0, 0.0)
    got = field_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (2, 4, f, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("f", [24, 175])
def test_matches_jax_reference_ragged_batch(f):
    q, k, v = _qkv(2, 4, f, 100, seed=7)
    want = jax_field_attention_reference(q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (field_attention(tq, tk, tv), field_attention_reference(tq, tk, tv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("f", [8, 24])
def test_backward_matches_jax_grad_of_the_kernel_interpret(f):
    import jax
    import jax.numpy as jnp

    q, k, v = _qkv(2, 4, f, 128, seed=f + 1)
    g = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_field_attention(*a, 0, 0.0) * g),
                    argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (field_attention(tq, tk, tv) * torch.from_numpy(g)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_plain_backward_matches_autograd_of_the_plain_forward(rate):
    """K5b's plain version (the kernel's formulas, the mask regenerated from
    the seed) against autograd through the plain forward, which applies the
    mask as a constant multiplier; F = 175 runs the plain versions in
    query-field chunks."""
    for h, dh, f, b in ((2, 4, 24, 64), (2, 4, 175, 8)):
        q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(h, dh, f, b, 5))
        do = torch.from_numpy(np.random.default_rng(6).standard_normal(
            (h, dh, f, b)).astype(np.float32))
        o = field_attention_reference(q, k, v, 12, rate)
        want = torch.autograd.grad(o, (q, k, v), do)
        o2, lse = field_attention_fwd_plain(q.detach(), k.detach(), v.detach(), 12, rate)
        torch.testing.assert_close(o2, o.detach(), rtol=0, atol=0)
        got = field_attention_bwd(q.detach(), k.detach(), v.detach(), o2, lse, do,
                                  12, rate)
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), w.numpy(), **GRAD_TOL)


def test_dropout_finite_differences_through_the_plain_forward():
    """As ``tests/test_kernels.py`` checks the TPU kernel: central
    differences of the loss through the plain forward at rate 0.2 (in
    float64, so the differences are exact to ~1e-9) agree with the plain
    backward, which holds only if the backward regenerates the forward's
    mask from the seed."""
    q, k, v = (torch.from_numpy(x).double() for x in _qkv(2, 4, 8, 128, seed=3))
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(q.shape))
    loss = lambda q_: float((field_attention_reference(q_, k, v, 7, 0.2) * g).sum())  # noqa: E731
    o, lse = field_attention_fwd_plain(q, k, v, 7, 0.2)
    gq = field_attention_bwd_reference(q, k, v, o, lse, g, 7, 0.2)[0]
    eps = 1e-4
    for idx in [(0, 0, 0, 0), (1, 2, 3, 17), (0, 3, 7, 100)]:
        dq = torch.zeros_like(q)
        dq[idx] = eps
        fd = (loss(q + dq) - loss(q - dq)) / (2 * eps)
        assert abs(fd - float(gq[idx])) < 1e-6 * max(1.0, abs(fd)), idx


def test_philox_known_answers():
    """Philox4x32-10's known-answer vectors (Salmon et al., Random123), which
    the kernels' device function follows word for word."""
    t = lambda x: torch.tensor([x], dtype=torch.int64)   # noqa: E731
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = philox4x32_10(*map(t, ctr), *key)
        assert tuple(int(w) for w in got) == want


def test_dropout_deterministic_per_seed_and_collision_free():
    q, k, v = map(torch.from_numpy, _qkv(2, 4, 8, 64, seed=1))
    a = field_attention(q, k, v, 7, 0.2)
    torch.testing.assert_close(field_attention(q, k, v, 7, 0.2), a, rtol=0, atol=0)
    assert float((field_attention(q, k, v, 8, 0.2) - a).abs().max()) > 0
    assert float((field_attention(q, k, v, (1 << 32) | 7, 0.2) - a).abs().max()) > 0
    # every (head, query, key, sample) draws its own word: masks of
    # neighbouring heads, queries, keys and samples are not copies
    m = dropout_scale(2, 8, 64, 7, 0.5, "cpu")
    for dim in range(4):
        assert not torch.equal(m.narrow(dim, 0, 1), m.narrow(dim, 1, 1)), dim
    # the chunked masks equal the whole one
    torch.testing.assert_close(dropout_scale(2, 8, 64, 7, 0.5, "cpu", 3, 4),
                               m[:, 3:7], rtol=0, atol=0)


def test_keep_rate():
    m = dropout_scale(2, 24, 1024, 11, 0.2, "cpu")
    keep = float((m > 0).float().mean())
    assert abs(keep - 0.8) < 0.01, keep
    assert set(torch.unique(m).tolist()) == {0.0, np.float32(1 / 0.8)}


def test_dropout_and_gradients_on_the_cpu_launch_nothing():
    reset_launch_counts()
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(2, 4, 8, 16, seed=1))
    field_attention(q, k, v, 3, 0.2).sum().backward()
    field_attention(q.detach(), k.detach(), v.detach())
    assert set(launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="rate"):
        field_attention(q, k, v, 3, 1.0)
    with pytest.raises(ValueError, match="seed"):
        field_attention(q, k, v, -1, 0.2)


def test_argument_checks():
    q, k, v = map(torch.from_numpy, _qkv(2, 4, 8, 16, seed=2))
    with pytest.raises(TypeError):
        field_attention(q.double(), k, v)
    with pytest.raises(ValueError):
        field_attention(q, k[:, :, :4], v)
    with pytest.raises(ValueError):
        field_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="no kernel"):
        field_attention(q.to("meta"), k.to("meta"), v.to("meta"))
