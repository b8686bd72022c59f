"""Port parity for K7's gathered entry, ``din_pool_gather``: its plain
version (the CPU path) against the JAX package's sequence path, the
``fold_rows_ref`` rows of the table sliced to a lane window and pooled by
the JAX ``din_pool`` in interpret mode, as the JAX package's own tests run
it on the CPU; then ``DINPool`` on a ``SequenceRows`` handle, and the
arguments the wrapper refuses.

Inputs are made with numpy from seeds: some rows of all-0 masks, and
padding ids (masked entries) that point at nonzero table rows, which must
not reach the pool.  Tolerance rtol 1e-5, atol 2e-6: float32 products
summed in another order by XLA-CPU and torch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.embedding import packed as jpk
from recommendsystem_tpu.kernels.din_pallas import din_pool as jax_din_pool
from recommendsystem_tpu_torch.embedding import packed
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.kernels.din import (din_pool, din_pool_gather,
                                                   din_pool_gather_plain)
from recommendsystem_tpu_torch.nn import DINPool

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)
ROWS, D, H = 336, 32, 16       # 336: a multiple of the JAX gather pack at D 32


def _inputs(b, t, seed):
    """numpy (query (B, 2H), table (ROWS, D), ids (B, T), mask (B, T), w1,
    b1, w2, b2): ragged lengths, row 0 and every fifth row all masked, the
    last row full; masked entries keep random (nonzero-row) ids."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 2 * H)).astype(np.float32)
    table = rng.normal(size=(ROWS, D)).astype(np.float32)
    ids = rng.integers(0, ROWS, size=(b, t)).astype(np.int32)
    lens = rng.integers(1, t + 1, size=(b,))
    lens[::5] = 0
    lens[-1] = t
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    lim1, lim2 = np.sqrt(6.0 / (4 * H + 16)), np.sqrt(6.0 / 17)
    w1 = rng.uniform(-lim1, lim1, size=(4 * H, 16)).astype(np.float32)
    b1 = rng.normal(scale=0.1, size=(16,)).astype(np.float32)
    w2 = rng.uniform(-lim2, lim2, size=(16, 1)).astype(np.float32)
    b2 = rng.normal(scale=0.1, size=(1,)).astype(np.float32)
    return q, table, ids, mask, w1, b1, w2, b2


def _jax_pool(q, table, ids, mask, lanes, w1, b1, w2, b2):
    """The JAX sequence path: K2's reference rows of the packed table, the
    lane window of each, then the JAX ``din_pool``."""
    b, t = ids.shape
    lo, hi = lanes
    flat, m = jnp.asarray(ids.reshape(-1)), jnp.asarray(mask.reshape(-1))
    wide = jpk.pack_table(jnp.asarray(table))[flat // jpk.gather_pack(D)]
    facts = jpk.fold_rows_ref(wide, flat, m, D)[:, lo:hi].reshape(b, t, hi - lo)
    return np.asarray(jax_din_pool(jnp.asarray(q[:, :H]), facts, jnp.asarray(mask),
                                   *map(jnp.asarray, (w1, b1, w2, b2))))


def _torch(q, table, ids, mask, w1, b1, w2, b2):
    q = torch.from_numpy(q)[:, :H]                   # a strided view, as the model's
    return (q, *map(torch.from_numpy, (table, ids, mask, w1, b1, w2, b2)))


@pytest.mark.parametrize("b,t,lanes", [(6, 4, (0, 16)), (11, 50, (0, 16)),
                                       (9, 17, (16, 32)), (5, 50, (8, 24)),
                                       (4, 33, (0, 16))])
def test_din_pool_gather_plain_matches_jax(b, t, lanes):
    args = _inputs(b, t, seed=b * t)
    q, table, ids, mask, w1, b1, w2, b2 = _torch(*args)
    assert not q.is_contiguous()
    assert float(mask[0].sum()) == 0.0 and float(table[ids[0].long()].abs().min()) > 0.0
    want = _jax_pool(*args[:4], lanes, *args[4:])
    got = din_pool_gather_plain(q, table, ids, mask, lanes, w1, b1, w2, b2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # a sequence with no live entry pools zero facts: 0, not its padding rows
    dead = (mask.sum(dim=1) == 0).nonzero().flatten()
    assert dead.numel() >= 1
    assert torch.equal(got[dead], torch.zeros((dead.numel(), H)))
    # the wrapper on CPU tensors is the plain version, and launches nothing
    reset_launch_counts()
    with torch.inference_mode():
        np.testing.assert_array_equal(
            din_pool_gather(q, table, ids, mask, lanes, w1, b1, w2, b2).numpy(),
            got.numpy())
    assert launch_counts()["din_pool"] == 0


def test_plain_version_is_fold_rows_then_din_pool():
    """Exactly the path the predict step took before: K2's rows, the lane
    window, then the pool over them."""
    q, table, ids, mask, w1, b1, w2, b2 = _torch(*_inputs(7, 12, seed=3))
    rows = packed.fold_rows(table, ids.reshape(-1), mask.reshape(-1)).reshape(7, 12, D)
    want = din_pool(q, rows[:, :, 0:H], mask, w1, b1, w2, b2)
    got = din_pool_gather_plain(q, table, ids, mask, (0, H), w1, b1, w2, b2)
    assert torch.equal(got, want)


def test_dinpool_takes_a_sequence_rows_handle():
    """``DINPool`` on a handle (window [0, 32) narrowed to [0, 16), as the
    staytime model takes it) equals the layer on the gathered rows."""
    q, table, ids, mask, *_ = _torch(*_inputs(8, 10, seed=4))
    pool = DINPool(H)
    handle = packed.SequenceRows(table, ids, mask, (0, D)).lanes(0, H)
    assert handle.window == (0, H)
    rows = packed.fold_rows_plain(table, ids.reshape(-1), mask.reshape(-1)).reshape(8, 10, D)
    with torch.inference_mode():
        got = pool(q, handle)
        want = pool(q, rows[:, :, 0:H], mask.bool())
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="own mask"):
        with torch.inference_mode():
            pool(q, handle, mask.bool())
    with pytest.raises(ValueError, match="outside"):
        handle.lanes(8, 24)


def test_din_pool_gather_refuses_what_it_does_not_take():
    q, table, ids, mask, w1, b1, w2, b2 = _torch(*_inputs(4, 6, seed=5))
    w = (w1, b1, w2, b2)
    with torch.no_grad():
        # a table whose rows are not 16-byte aligned: the kernel's launcher
        # refuses it on a card; the plain version takes it
        flat = torch.cat([torch.zeros(1), table.reshape(-1)])
        shifted = flat[1:].view(ROWS, D)
        assert shifted.data_ptr() % 16
        assert torch.equal(din_pool_gather(q, shifted, ids, mask, (0, H), *w),
                           din_pool_gather(q, table, ids, mask, (0, H), *w))
        # lane windows: narrower than the query, off a multiple of 4, past D
        for lanes in ((0, 8), (2, 18), (24, 40)):
            with pytest.raises(ValueError, match="lanes"):
                din_pool_gather(q, table, ids, mask, lanes, *w)
        # a D the 16-byte chunks do not tile
        with pytest.raises(ValueError, match="D % 4"):
            din_pool_gather(q, table[:, :30].contiguous(), ids, mask, (0, H), *w)
        # inputs on two devices
        with pytest.raises(ValueError, match="on meta"):
            din_pool_gather(q, table, ids.to("meta"), mask, (0, H), *w)
        with pytest.raises(ValueError, match="more than one device"):
            din_pool_gather(q.to("meta"), table, ids, mask, (0, H), *w)
        with pytest.raises(TypeError):                          # int64 ids
            din_pool_gather(q, table, ids.long(), mask, (0, H), *w)
        with pytest.raises(ValueError, match="do not fit"):     # query of 3 rows
            din_pool_gather(q[:3], table, ids, mask, (0, H), *w)
    # no gradient: an input that needs one is refused, not dropped
    w1.requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        din_pool_gather(q, table, ids, mask, (0, H), w1, b1, w2, b2)
