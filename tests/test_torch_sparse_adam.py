"""Port parity for the lazy per-row Adam: ``SparseAdam`` (the port's plain
optimizer) and K8 ``sparse_adam_update`` (its CPU path, the kernel's plain
version), against the JAX package's ``SparseAdam.update`` and its one-pass
``packed_adam_update`` read through ``pack_state_entry`` /
``unpack_state_entry``.

Tolerances: w atol 1e-7, m and v rtol 1e-6 (the same float32 arithmetic;
``beta ** t`` of torch and of XLA may differ in the last bit, and so may
the step that divides by it); rows whose count is 0 bit-identical; t and
show exact (sums of 1.0 and of integer counts)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.embedding import SparseAdam as JaxSparseAdam
from recommendsystem_tpu.embedding import packed as jpk
from recommendsystem_tpu_torch.embedding import packed
from recommendsystem_tpu_torch.embedding.optimizers import SparseAdam
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.kernels._build import KERNELS

torch.set_num_threads(1)
W_ATOL = 1e-7
MOMENT = dict(rtol=1e-6, atol=0)
ROWS, D = 14 * 12, 8


def _state(rng, rows=ROWS, d=D):
    return {"w": rng.standard_normal((rows, d)).astype(np.float32) / 3,
            "opt": {"m": rng.standard_normal((rows, d)).astype(np.float32) * 1e-3,
                    "v": rng.uniform(0, 1e-5, (rows, d)).astype(np.float32),
                    "t": rng.integers(0, 5, (rows, 1)).astype(np.float32)},
            "show": rng.integers(0, 9, (rows, 1)).astype(np.float32)}


def _acc(rng, rows=ROWS, d=D, live=0.4):
    """(rows, D+1) [grad | count] rows, the JAX package's layout: a share
    ``live`` of rows with counts 1..4 and gradients, the others all zero, as
    the unfold-scatter leaves it."""
    cnt = np.where(rng.uniform(size=(rows, 1)) < live,
                   rng.integers(1, 5, (rows, 1)), 0).astype(np.float32)
    g = rng.standard_normal((rows, d)).astype(np.float32) * 1e-2 * (cnt > 0)
    return np.concatenate([g, cnt], axis=1)


def _flat(acc):
    """The port's accumulator of the same sums: a flat tensor of the (rows,
    D) gradient block followed by the (rows,) counts."""
    return torch.tensor(np.concatenate([acc[:, :-1].ravel(), acc[:, -1]]))


def _torch(state):
    return {"w": torch.tensor(state["w"]),
            "opt": {n: torch.tensor(x) for n, x in state["opt"].items()},
            "show": torch.tensor(state["show"])}


def _assert_state(got, want, before, cnt):
    np.testing.assert_allclose(got["w"], want["w"], rtol=0, atol=W_ATOL)
    for name in ("m", "v"):
        np.testing.assert_allclose(got["opt"][name], want["opt"][name], **MOMENT)
    np.testing.assert_array_equal(got["opt"]["t"], want["opt"]["t"])
    np.testing.assert_array_equal(got["show"], want["show"])
    dead = cnt[:, 0] == 0
    np.testing.assert_array_equal(got["w"][dead], before["w"][dead])
    for name in ("m", "v", "t"):
        np.testing.assert_array_equal(got["opt"][name][dead], before["opt"][name][dead])
    np.testing.assert_array_equal(got["show"][dead], before["show"][dead])


def _np(state):
    return {"w": np.asarray(state["w"]),
            "opt": {n: np.asarray(x) for n, x in state["opt"].items()},
            "show": np.asarray(state["show"])}


@pytest.mark.parametrize("lr", [5e-5, 1e-2])
def test_sparse_adam_update_matches_jax(lr):
    rng = np.random.default_rng(int(lr * 1e5))
    before, acc = _state(rng), _acc(rng)
    g, cnt = acc[:, :D], acc[:, D:]
    row_mask = (cnt > 0).astype(np.float32)
    jw, jopt = JaxSparseAdam(learning_rate=lr).update(
        jnp.asarray(before["w"]), jnp.asarray(g),
        {n: jnp.asarray(x) for n, x in before["opt"].items()}, jnp.asarray(row_mask))
    pw, popt = SparseAdam(learning_rate=lr).update(
        torch.tensor(before["w"]), torch.tensor(g),
        {n: torch.tensor(x) for n, x in before["opt"].items()}, torch.tensor(row_mask))
    want = {"w": np.asarray(jw), "opt": _np({"w": 0, "opt": jopt, "show": 0})["opt"],
            "show": before["show"] + cnt}
    got = {"w": pw.numpy(), "opt": {n: x.numpy() for n, x in popt.items()},
           "show": before["show"] + cnt}
    _assert_state(got, want, before, cnt)


def test_update_rows_matches_jax():
    rng = np.random.default_rng(3)
    before = _state(rng, rows=32)
    g = rng.standard_normal((32, D)).astype(np.float32) * 1e-2
    valid = (rng.uniform(size=(32, 1)) < 0.7).astype(np.float32)
    jw, jopt = JaxSparseAdam().update_rows(
        jnp.asarray(before["w"]), jnp.asarray(g),
        {n: jnp.asarray(x) for n, x in before["opt"].items()}, jnp.asarray(valid))
    pw, popt = SparseAdam().update_rows(
        torch.tensor(before["w"]), torch.tensor(g),
        {n: torch.tensor(x) for n, x in before["opt"].items()}, torch.tensor(valid))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=0, atol=W_ATOL)
    for name in ("m", "v"):
        np.testing.assert_allclose(popt[name].numpy(), np.asarray(jopt[name]), **MOMENT)
    np.testing.assert_array_equal(popt["t"].numpy(), np.asarray(jopt["t"]))


@pytest.mark.parametrize("live", [0.0, 0.4, 1.0])
def test_k8_matches_jax_packed_adam_update(live):
    """K8's CPU path against the JAX one-pass packed Adam on the same state,
    packed by ``pack_state_entry`` and read back by ``unpack_state_entry``."""
    rng = np.random.default_rng(int(live * 10) + 7)
    before, acc = _state(rng), _acc(rng, live=live)
    opt = SparseAdam()
    ps = jpk.scatter_pack(D)
    jacc = jnp.asarray(np.pad(acc.reshape(ROWS // ps, ps * (D + 1)),
                              ((0, 0), (0, 128 - ps * (D + 1)))))
    jnew = jpk.packed_adam_update(JaxSparseAdam(), jpk.pack_state_entry(
        {"w": jnp.asarray(before["w"]),
         "opt": {n: jnp.asarray(x) for n, x in before["opt"].items()},
         "show": jnp.asarray(before["show"])}, D), jacc, D)
    want = _np(jpk.unpack_state_entry(jnew, D))
    tstate, tacc = _torch(before), _flat(acc)
    reset_launch_counts()
    assert packed.sparse_adam_update(opt, tstate, tacc) is None     # in place
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    _assert_state(_np(tstate), want, before, acc[:, D:])
    assert not tacc.any()                       # the accumulator is left zero


def test_k8_equals_its_oracle_bit_for_bit():
    rng = np.random.default_rng(11)
    before, acc = _state(rng), _acc(rng)
    opt = SparseAdam(learning_rate=1e-3)
    tstate = _torch(before)
    packed.sparse_adam_update(opt, tstate, _flat(acc))
    w, st = opt.update(torch.tensor(before["w"]), torch.tensor(acc[:, :D]),
                       {n: torch.tensor(x) for n, x in before["opt"].items()},
                       torch.tensor((acc[:, D:] > 0).astype(np.float32)))
    torch.testing.assert_close(tstate["w"], w, rtol=0, atol=0)
    for name in ("m", "v", "t"):
        torch.testing.assert_close(tstate["opt"][name], st[name], rtol=0, atol=0)
    torch.testing.assert_close(tstate["show"], torch.tensor(before["show"] + acc[:, D:]),
                               rtol=0, atol=0)


def test_k8_checks_arguments():
    rng = np.random.default_rng(0)
    tstate, acc = _torch(_state(rng)), _flat(_acc(rng))
    opt = SparseAdam()
    with pytest.raises(ValueError):
        packed.sparse_adam_update(opt, tstate, acc[:ROWS * D])     # no counts
    bad = dict(tstate, show=tstate["show"].double())
    with pytest.raises(TypeError):
        packed.sparse_adam_update(opt, bad, acc)
    bad = dict(tstate, opt=dict(tstate["opt"], m=tstate["opt"]["m"][:-1]))
    with pytest.raises(ValueError):
        packed.sparse_adam_update(opt, bad, acc)
    meta = {"w": tstate["w"].to("meta"),
            "opt": {n: x.to("meta") for n, x in tstate["opt"].items()},
            "show": tstate["show"].to("meta")}
    with pytest.raises(ValueError, match="no kernel"):
        packed.sparse_adam_update(opt, meta, acc.to("meta"))


def test_init_state_and_table_init():
    opt = SparseAdam()
    st = opt.init_state((50, D))
    assert {n: tuple(x.shape) for n, x in st.items()} == {
        "m": (50, D), "v": (50, D), "t": (50, 1)}
    assert not any(x.any() for x in st.values())
    w = opt.table_init(torch.Generator().manual_seed(0), (4000, D))
    assert w.dtype == torch.float32 and w.shape == (4000, D)
    assert float(w.abs().max()) <= 2 / D ** 0.5            # truncated at 2 sigma
    np.testing.assert_allclose(float(w.std()), 0.88 / D ** 0.5, rtol=0.05)


# storages of a group: (rows, D); odd row counts and two widths, as ctr's
# 48-wide rows beside autoint's 8
GROUP = ((13, 8), (7, 48), (31, 8), (5, 48))


def _group(rng, shapes, live=0.4):
    return [(_state(rng, rows, d), _acc(rng, rows, d, live)) for rows, d in shapes]


@pytest.mark.parametrize("live", [0.0, 0.3, 1.0])
def test_k8_group_equals_per_storage_plain_bit_for_bit(live):
    """The grouped pass's CPU path over storages of D 8 and 48 against
    ``sparse_adam_update_plain`` on each storage in turn."""
    rng = np.random.default_rng(int(live * 10) + 21)
    group = _group(rng, GROUP, live)
    opt = SparseAdam(learning_rate=1e-3)
    got = [(_torch(s), _flat(a)) for s, a in group]
    want = [(_torch(s), _flat(a)) for s, a in group]
    reset_launch_counts()
    assert packed.sparse_adam_update_group(opt, [s for s, _ in got],
                                           [a for _, a in got]) is None
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    for s, a in want:
        packed.sparse_adam_update_plain(opt, s, a)
    for (gs, ga), (ws, _), (before, acc) in zip(got, want, group):
        torch.testing.assert_close(gs["w"], ws["w"], rtol=0, atol=0)
        for name in ("m", "v", "t"):
            torch.testing.assert_close(gs["opt"][name], ws["opt"][name], rtol=0, atol=0)
        torch.testing.assert_close(gs["show"], ws["show"], rtol=0, atol=0)
        assert not ga.any()
        d = acc.shape[1] - 1
        dead = acc[:, d] == 0
        np.testing.assert_array_equal(gs["w"].numpy()[dead], before["w"][dead])


@pytest.mark.parametrize("live", [0.3, 1.0])
def test_k8_group_matches_jax_packed_adam_update(live):
    """Each storage of a grouped pass against the JAX one-pass packed Adam
    on the same state (``pack_state_entry`` / ``unpack_state_entry``); row
    counts are multiples of the JAX scatter pack (14 rows a 128-lane row at
    D = 8, 2 at D = 48)."""
    rng = np.random.default_rng(int(live * 10) + 31)
    shapes = ((42, 8), (18, 48), (70, 8), (26, 48))
    group = _group(rng, shapes, live)
    tstates = [_torch(s) for s, _ in group]
    packed.sparse_adam_update_group(SparseAdam(), tstates,
                                    [_flat(a) for _, a in group])
    for tstate, (before, acc), (rows, d) in zip(tstates, group, shapes):
        ps = jpk.scatter_pack(d)
        jacc = jnp.asarray(np.pad(acc.reshape(rows // ps, ps * (d + 1)),
                                  ((0, 0), (0, 128 - ps * (d + 1)))))
        jnew = jpk.packed_adam_update(JaxSparseAdam(), jpk.pack_state_entry(
            {"w": jnp.asarray(before["w"]),
             "opt": {n: jnp.asarray(x) for n, x in before["opt"].items()},
             "show": jnp.asarray(before["show"])}, d), jacc, d)
        _assert_state(_np(tstate), _np(jpk.unpack_state_entry(jnew, d)), before,
                      acc[:, d:])


def test_k8_group_checks_arguments():
    rng = np.random.default_rng(5)
    (s1, a1), (s2, a2) = _group(rng, GROUP[:2])
    t1, t2 = _torch(s1), _torch(s2)
    opt = SparseAdam()
    with pytest.raises(ValueError, match="accumulators"):
        packed.sparse_adam_update_group(opt, [t1, t2], [_flat(a1)])
    with pytest.raises(ValueError):              # the second storage's acc is the first's
        packed.sparse_adam_update_group(opt, [t1, t2], [_flat(a1)] * 2)
    meta = {"w": t2["w"].to("meta"), "opt": {n: x.to("meta") for n, x in t2["opt"].items()},
            "show": t2["show"].to("meta")}
    with pytest.raises(ValueError):              # storages on two devices
        packed.sparse_adam_update_group(opt, [t1, meta], [_flat(a1),
                                                          _flat(a2).to("meta")])
    assert packed.sparse_adam_update_group(opt, [], []) is None
