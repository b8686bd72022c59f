"""Port parity for the grouped K1 (``fold_mean_group``) and K3
(``unfold_mean_scatter_group``): each member of a group, through the CPU
path (the kernels' plain versions), against the JAX package's ``fold_mean``
and ``unfold_mean`` + scatter on the same member, as the JAX package's own
tests run them on the CPU (their plain references); and the stage
functions, which now make one grouped call a step.

Tolerance: atol 1e-6 (each output sums at most 10 float32 products of
magnitude < 4, in another order than the JAX selection matmul); counts
exact (sums of 1.0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.embedding import packed as jpk
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.embedding import packed
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.kernels._build import KERNELS
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.train import create_train_state, make_train_step

torch.set_num_threads(1)
ATOL = 1e-6
ROWS = 336      # a multiple of the JAX gather and scatter packs at D 8, 16, 32

# members of a group: (D, L, C, B, share of live ids forced onto row 0)
MEMBERS = [(8, 5, 2, 16, 0.1), (16, 2, 3, 40, 0.0), (32, 10, 1, 24, 0.5),
           (8, 10, 2, 0, 0.0), (16, 5, 1, 7, 1.0), (8, 2, 1, 33, 0.0)]


def _stream(rng, c, l, b, hot):
    """l-major ids/mask of c columns: ragged live counts (0..L a row),
    padding id 0 with mask 0, a share ``hot`` of the live ids on row 0."""
    lens = rng.integers(0, l + 1, size=(c, b))
    mask = (np.arange(l)[None, :, None] < lens[:, None, :]).astype(np.float32)
    ids = rng.integers(0, ROWS, size=(c, l, b)).astype(np.int32)
    ids[rng.uniform(size=ids.shape) < hot] = 0
    ids = ids * mask.astype(np.int32)
    return ids.reshape(-1), mask.reshape(-1)


def _members(seed):
    rng = np.random.default_rng(seed)
    out = []
    for d, l, c, b, hot in MEMBERS:
        w = (rng.standard_normal((ROWS, d)) / np.sqrt(d)).astype(np.float32)
        ids, mask = _stream(rng, c, l, b, hot)
        g = rng.standard_normal((c * b, d)).astype(np.float32)
        out.append((w, ids, mask, c, l, g))
    return out


def _jax_fold(w, ids, mask, c, l):
    d = w.shape[1]
    wide = jpk.pack_table(jnp.asarray(w))[jnp.asarray(ids) // jpk.gather_pack(d)]
    return np.asarray(jpk.fold_mean(wide, jnp.asarray(ids), jnp.asarray(mask), c, l, d))


def test_fold_mean_group_matches_jax_per_member():
    members = _members(1)
    items = [(torch.from_numpy(w), torch.from_numpy(ids), torch.from_numpy(mask), c, l)
             for w, ids, mask, c, l, _ in members]
    reset_launch_counts()
    got = packed.fold_mean_group(items)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert len(got) == len(members)
    for out, (w, ids, mask, c, l, _) in zip(got, members):
        b = ids.shape[0] // (c * l)
        assert out.shape == (c * b, w.shape[1]) and out.dtype == torch.float32
        if b:
            np.testing.assert_allclose(out.numpy(), _jax_fold(w, ids, mask, c, l),
                                       rtol=0, atol=ATOL)
    # each member its own tensor, as the train step differentiates each
    assert len({o.data_ptr() for o in got if o.numel()}) == sum(o.numel() > 0 for o in got)


def test_fold_mean_is_a_group_of_one():
    w, ids, mask, c, l, _ = _members(2)[0]
    args = (torch.from_numpy(w), torch.from_numpy(ids), torch.from_numpy(mask), c, l)
    torch.testing.assert_close(packed.fold_mean(*args), packed.fold_mean_group([args])[0],
                               rtol=0, atol=0)


def _jax_accumulate(acc, g, ids, mask, c, l):
    """The JAX payload of one member scattered into a (ROWS/Ps, 128)
    accumulator (``apply_gradients_packed``, ``packed.py:661-671``)."""
    d = g.shape[1]
    ps = jpk.scatter_pack(d)
    if acc is None:
        acc = jnp.zeros((ROWS // ps, 128), jnp.float32)
    pay = jpk.unfold_mean(jnp.asarray(g), jnp.asarray(ids), jnp.asarray(mask), c, l)
    return acc.at[jnp.asarray(ids) // ps].add(pay)


def _jax_rows(acc, d):
    ps = jpk.scatter_pack(d)
    return np.asarray(acc[:, :ps * (d + 1)].reshape(ROWS, d + 1))


def test_unfold_mean_scatter_group_matches_jax_per_member():
    """One member a column, as ``apply_gradients_packed`` makes them; the
    members of one D share one accumulator, as the columns of a storage do."""
    members = _members(3)
    accs = {d: torch.zeros(ROWS * (d + 1)) for d, *_ in MEMBERS}
    jaccs = dict.fromkeys(accs)
    items = []
    for w, ids, mask, c, l, g in members:
        d = w.shape[1]
        b = ids.shape[0] // (c * l)
        for ci in range(c):
            part = slice(ci * l * b, (ci + 1) * l * b)
            gc = g[ci * b:(ci + 1) * b]
            items.append((*packed.accumulator_views(accs[d], d), torch.from_numpy(gc),
                          torch.from_numpy(ids[part]), torch.from_numpy(mask[part]), l))
            if b:
                jaccs[d] = _jax_accumulate(jaccs[d], gc, ids[part], mask[part], 1, l)
    reset_launch_counts()
    assert packed.unfold_mean_scatter_group(items) is None
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    for d, acc in accs.items():
        got = torch.cat(packed.accumulator_views(acc, d), dim=1).numpy()
        want = _jax_rows(jaccs[d], d)
        np.testing.assert_allclose(got[:, :d], want[:, :d], rtol=0, atol=ATOL)
        np.testing.assert_array_equal(got[:, d], want[:, d])
    live = sum(float(m.sum()) for _, _, m, _, _, _ in members)
    assert sum(float(packed.accumulator_views(a, d)[1].sum()) for d, a in accs.items()) == live


def test_unfold_mean_scatter_is_a_group_of_one():
    w, ids, mask, c, l, g = _members(4)[0]
    b = ids.shape[0] // (c * l)
    args = (torch.from_numpy(g[:b]), torch.from_numpy(ids[:l * b]),
            torch.from_numpy(mask[:l * b]), l)
    one, grouped = torch.zeros(ROWS * 9), torch.zeros(ROWS * 9)
    packed.unfold_mean_scatter(*packed.accumulator_views(one, 8), *args)
    packed.unfold_mean_scatter_group([(*packed.accumulator_views(grouped, 8), *args)])
    torch.testing.assert_close(one, grouped, rtol=0, atol=0)


def test_groups_check_their_members():
    table = torch.randn(64, 8)
    ids = torch.zeros(10, dtype=torch.int32)
    mask = torch.ones(10)
    assert packed.fold_mean_group([]) == []
    assert packed.unfold_mean_scatter_group([]) is None
    with pytest.raises(ValueError, match="members on"):          # two devices
        packed.fold_mean_group([(table, ids, mask, 1, 5),
                                (table.to("meta"), ids.to("meta"), mask.to("meta"), 1, 5)])
    with pytest.raises(TypeError):                               # float64 table
        packed.fold_mean_group([(table, ids, mask, 1, 5), (table.double(), ids, mask, 1, 5)])
    with pytest.raises(ValueError):                              # 10 ids != 3 x 5 x B
        packed.fold_mean_group([(table, ids, mask, 3, 5)])
    grads, counts = packed.accumulator_views(torch.zeros(64 * 9), 8)
    g = torch.ones(2, 8)
    with pytest.raises(ValueError, match="members on"):
        packed.unfold_mean_scatter_group([(grads, counts, g, ids, mask, 5),
                                          (grads.to("meta"), counts.to("meta"), g.to("meta"),
                                           ids.to("meta"), mask.to("meta"), 5)])
    with pytest.raises(TypeError):                               # int64 ids
        packed.unfold_mean_scatter_group([(grads, counts, g, ids.long(), mask, 5)])
    with pytest.raises(ValueError):                              # 10 ids != 4 x 2
        packed.unfold_mean_scatter_group([(grads, counts, g, ids, mask, 4)])
    # a gradient of another D than the accumulator's: D 2 (its D+1 divides
    # the 576 floats) and D 5
    for d in (2, 5):
        with pytest.raises(ValueError, match="grads"):
            packed.unfold_mean_scatter_group([(grads, counts, torch.ones(5, d), ids, mask, 2)])
    with pytest.raises(ValueError, match="counts"):              # another storage's rows
        packed.unfold_mean_scatter_group([(grads, counts[:63], g, ids, mask, 5)])


@pytest.fixture(scope="module")
def autoint():
    """A small autoint bundle whose 24 tables are 24 storages (one mean
    column each), as at full width."""
    import dataclasses

    from recommendsystem_tpu_torch.embedding import EmbeddingFeatures

    bundle = create_model("autoint", bucket_size=256, device="cpu")
    eng = bundle.embedding
    return dataclasses.replace(bundle, embedding=EmbeddingFeatures(
        list(eng.columns.values()), eng.sparse_opt, group_tables=True, max_group_bytes=1))


def _spy(monkeypatch, name):
    calls = []
    real = getattr(packed, name)

    def spy(items):
        items = list(items)
        calls.append(len(items))
        return real(items)
    monkeypatch.setattr(packed, name, spy)
    return calls


@pytest.mark.parametrize("ids_per_feature,members", [(5, 24), (1, 0)])
def test_train_step_makes_one_grouped_fold_and_unfold(autoint, monkeypatch,
                                                      ids_per_feature, members):
    """With 5 ids the step folds and unfolds its 24 mean columns in one
    grouped call each; with 1 id the columns take K2 and K4 and the groups
    are empty."""
    assert len(autoint.embedding.storage) == 24
    folds = _spy(monkeypatch, "fold_mean_group")
    unfolds = _spy(monkeypatch, "unfold_mean_scatter_group")
    state = create_train_state(autoint, seed=0)
    batch, dense, labels, weight = synthetic_batch(autoint, 16, seed=2,
                                                   ids_per_feature=ids_per_feature)
    step = make_train_step(autoint)
    state, info = step(state, batch, labels, weight, dense, seed=0)
    assert folds == [members] and unfolds == [members]
    assert np.isfinite(float(info["loss"]))
