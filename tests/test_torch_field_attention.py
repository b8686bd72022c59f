"""Port parity for K5 forward, field attention (rate 0).

The JAX kernel runs in Pallas interpret mode on the CPU, as
``tests/test_kernels.py`` runs it.  Tolerance rtol = atol = 1e-5: softmax
over at most 24 keys and a 4-term contraction in float32, summed in another
order than the JAX kernel's."""

import numpy as np
import pytest
import torch

from recommendsystem_tpu.kernels.field_attention_pallas import (
    field_attention as jax_field_attention,
    field_attention_reference as jax_field_attention_reference,
)
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.kernels.field_attention import (
    field_attention,
    field_attention_reference,
)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


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


def test_dropout_waits_for_slice_2_and_cpu_launches_nothing():
    reset_launch_counts()
    q, k, v = map(torch.from_numpy, _qkv(2, 4, 8, 16, seed=1))
    with pytest.raises(NotImplementedError, match="slice 2"):
        field_attention(q, k, v, 3, 0.2)
    field_attention(q, k, v)
    assert launch_counts()["field_attention"] == 0


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
