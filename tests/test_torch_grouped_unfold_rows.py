"""The grouped K4, ``unfold_rows_scatter_group``, on the CPU (its plain
version) against separate ``unfold_rows_scatter_plain`` calls and against
the JAX package's ``unfold_rows_ref`` payloads scattered into its packed
accumulator; and the train step's one grouped call for every single-id
column.

180 members, as the 212-feature ctr's step has single-id columns, over
three accumulators of D 8, 56 and 16 that several members share, with hot
rows and an empty member.  Tolerance: gradient sums atol 1e-6 (each row
adds a few dozen float32 gradients of magnitude < 5 in another order),
counts exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.embedding import packed as jpk
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.embedding import packed
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.train import create_train_state, make_train_step

torch.set_num_threads(1)
ATOL = 1e-6
# (D, rows): rows a multiple of each D's JAX scatter packing
ACCS = ((8, 14 * 20), (56, 2 * 150), (16, 7 * 40))


def _members(n=180, seed=0):
    """n (accumulator index, g, ids, mask) members: ragged sizes 0-60 (the
    fourth member empty), a third of the entries masked with padding id 0,
    every seventh member's live entries all on row 3."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a = i % len(ACCS)
        d, rows = ACCS[a]
        e = 0 if i == 3 else int(rng.integers(1, 61))
        mask = (rng.uniform(size=e) > 0.33).astype(np.float32)
        ids = rng.integers(0, rows, size=e).astype(np.int32)
        if i % 7 == 0:
            ids[:] = 3
        ids = ids * mask.astype(np.int32)
        g = (rng.standard_normal((e, d)) * 2).astype(np.float32)
        out.append((a, g, ids, mask))
    return out


def _jax_accumulators(members):
    """Each accumulator as JAX builds it: the (E, 128) payload of
    ``unfold_rows_ref`` scattered into the packed (rows / Ps, 128)
    accumulator, unpacked to (rows, D+1) [grad | count] rows."""
    accs = []
    for a, (d, rows) in enumerate(ACCS):
        ps = jpk.scatter_pack(d)
        acc = jnp.zeros((rows // ps, 128), jnp.float32)
        for ai, g, ids, mask in members:
            if ai == a and len(ids):
                pay = jpk.unfold_rows_ref(jnp.asarray(g), ids, mask)
                acc = acc.at[ids // ps].add(pay)
        accs.append(np.asarray(acc[:, :ps * (d + 1)].reshape(rows, d + 1)))
    return accs


def _port_accumulators():
    return [torch.zeros(rows * (d + 1)) for d, rows in ACCS]


def _items(accs, members):
    views = [packed.accumulator_views(acc, d) for acc, (d, _) in zip(accs, ACCS)]
    return [(*views[a], torch.from_numpy(g), torch.from_numpy(ids), torch.from_numpy(mask))
            for a, g, ids, mask in members]


def _rows(acc, d):
    return torch.cat(packed.accumulator_views(acc, d), dim=1).numpy()


@pytest.mark.parametrize("n", [180, 5])
def test_group_matches_separate_calls_and_jax(n):
    members = _members(n)
    reset_launch_counts()
    grouped, separate = _port_accumulators(), _port_accumulators()
    packed.unfold_rows_scatter_group(_items(grouped, members))
    for item in _items(separate, members):
        packed.unfold_rows_scatter_plain(*item)
    assert set(launch_counts().values()) == {0}        # the CPU launches nothing
    for acc_g, acc_s, want, (d, _) in zip(grouped, separate, _jax_accumulators(members),
                                          ACCS):
        assert torch.equal(acc_g, acc_s)
        got = _rows(acc_g, d)
        np.testing.assert_allclose(got[:, :d], want[:, :d], rtol=0, atol=ATOL)
        np.testing.assert_array_equal(got[:, d], want[:, d])
    live = sum(float(m.sum()) for _, _, _, m in members)
    assert sum(float(_rows(a, d)[:, d].sum()) for a, (d, _) in zip(grouped, ACCS)) == live


def test_group_checks_its_members():
    accs = _port_accumulators()
    items = _items(accs, _members(6))
    assert packed.unfold_rows_scatter_group([]) is None
    grads, counts, g, ids, mask = items[0]
    with pytest.raises(ValueError, match="members on"):
        packed.unfold_rows_scatter_group(
            [items[0], tuple(t.to("meta") for t in items[1])])
    with pytest.raises(ValueError, match="grads"):                 # D 56 into D 8
        packed.unfold_rows_scatter_group([items[0], (grads, counts) + items[1][2:]])
    with pytest.raises(ValueError, match="counts"):                # a shared view, cut
        packed.unfold_rows_scatter_group([items[0], (grads, counts[:-1], g, ids, mask)])
    with pytest.raises(ValueError):                                # 2 ids a row
        packed.unfold_rows_scatter_group([(grads, counts, g, ids.repeat(2), mask.repeat(2))])
    with pytest.raises(TypeError):
        packed.unfold_rows_scatter_group([(grads, counts, g, ids.long(), mask)])


def test_train_step_groups_every_single_id_column(monkeypatch):
    """With 1 id a column the step hands all 24 of autoint's single-id
    columns to one grouped K4 call, one member a column; with 5 ids it
    hands it none."""
    bundle = create_model("autoint", bucket_size=64, device="cpu")
    calls = []
    real = packed.unfold_rows_scatter_group

    def spy(items):
        items = list(items)
        calls.append(len(items))
        return real(items)

    monkeypatch.setattr(packed, "unfold_rows_scatter_group", spy)
    step = make_train_step(bundle)
    for ipf, want in ((1, [24]), (5, [0])):
        calls.clear()
        batch, dense, labels, weight = synthetic_batch(bundle, 16, seed=2, ids_per_feature=ipf)
        step(create_train_state(bundle, seed=0), batch, labels, weight, dense, seed=0)
        assert calls == want
