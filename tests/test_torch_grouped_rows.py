"""Port parity for the grouped K2 (``fold_rows_group``): each member of a
group, through the CPU path (the kernel's plain version), against the JAX
package's ``fold_rows_ref`` on the same member, as the JAX package's own
tests run it on the CPU; and the predict step, which now makes one grouped
K2 call for its single-id segments and gathers no sequence (the DIN pools
take ``SequenceRows`` handles).

Tolerance: atol 1e-6 (one float32 product per output, against the JAX
selection matmul at full precision)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.embedding import packed as jpk
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.embedding import EmbeddingFeatures, packed
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.kernels._build import KERNELS
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
from recommendsystem_tpu_torch.nn import din as port_din
from recommendsystem_tpu_torch.train import create_train_state, make_predict_step

torch.set_num_threads(1)
ATOL = 1e-6
ROWS = 336      # a multiple of the JAX gather pack at D 8, 32 and 56

# members of a group: (D, E, share of live ids forced onto row 0)
MEMBERS = [(8, 40, 0.1), (32, 27, 0.0), (56, 16, 0.5), (8, 0, 0.0), (32, 64, 1.0),
           (56, 5, 0.0)]


def _members(seed):
    """(table, ids, mask) of each member: a quarter of the entries masked,
    their ids left random (padding over nonzero rows)."""
    rng = np.random.default_rng(seed)
    out = []
    for d, e, hot in MEMBERS:
        w = (rng.standard_normal((ROWS, d)) / np.sqrt(d)).astype(np.float32)
        ids = rng.integers(0, ROWS, size=(e,)).astype(np.int32)
        ids[rng.uniform(size=e) < hot] = 0
        mask = (rng.uniform(size=e) > 0.25).astype(np.float32)
        out.append((w, ids, mask))
    return out


def _jax_rows(w, ids, mask):
    d = w.shape[1]
    wide = jpk.pack_table(jnp.asarray(w))[jnp.asarray(ids) // jpk.gather_pack(d)]
    return np.asarray(jpk.fold_rows_ref(wide, jnp.asarray(ids), jnp.asarray(mask), d))


def test_fold_rows_group_matches_jax_per_member():
    members = _members(1)
    items = [tuple(map(torch.from_numpy, m)) for m in members]
    reset_launch_counts()
    got = packed.fold_rows_group(items)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert len(got) == len(members)
    for out, (w, ids, mask) in zip(got, members):
        assert out.shape == (ids.shape[0], w.shape[1]) and out.dtype == torch.float32
        if ids.shape[0]:
            np.testing.assert_allclose(out.numpy(), _jax_rows(w, ids, mask),
                                       rtol=0, atol=ATOL)
            # masked entries are 0, not the rows under their padding ids
            assert not out[torch.from_numpy(mask) == 0].any()
    # each member its own tensor, as the train step differentiates each
    assert len({o.data_ptr() for o in got if o.numel()}) == sum(o.numel() > 0 for o in got)


def test_fold_rows_is_a_group_of_one():
    w, ids, mask = map(torch.from_numpy, _members(2)[1])
    torch.testing.assert_close(packed.fold_rows(w, ids, mask),
                               packed.fold_rows_group([(w, ids, mask)])[0], rtol=0, atol=0)
    # a single-id mean column is a per-row fold too
    torch.testing.assert_close(packed.fold_mean(w, ids, mask, 1, 1),
                               packed.fold_rows(w, ids, mask), rtol=0, atol=0)


def test_fold_rows_group_checks_its_members():
    table = torch.randn(64, 8)
    ids = torch.zeros(10, dtype=torch.int32)
    mask = torch.ones(10)
    assert packed.fold_rows_group([]) == []
    with pytest.raises(ValueError, match="members on"):          # CPU and another device
        packed.fold_rows_group([(table, ids, mask),
                                (table.to("meta"), ids.to("meta"), mask.to("meta"))])
    with pytest.raises(ValueError):                              # ids on another device
        packed.fold_rows_group([(table, ids.to("meta"), mask)])
    with pytest.raises(TypeError):                               # float64 table
        packed.fold_rows_group([(table, ids, mask), (table.double(), ids, mask)])
    with pytest.raises(ValueError):                              # mask of 5 for 10 ids
        packed.fold_rows_group([(table, ids, mask[:5])])
    with pytest.raises(ValueError):                              # ids not (E,)
        packed.fold_rows_group([(table, ids.view(2, 5), mask.view(2, 5))])


@pytest.fixture(scope="module")
def staytime():
    """A small staytime bundle whose tables are split into storages of
    three (mean and sequence columns share storages in several ways), and
    its state."""
    bundle = create_model("staytime", cfg=StaytimeConfig(bucket_size=64, seq_max_len=5),
                          deep_hidden_units=(16, 8), device="cpu")
    eng = bundle.embedding
    small = EmbeddingFeatures(list(eng.columns.values()), eng.sparse_opt,
                              group_tables=True, max_group_bytes=3 * 72 * 32 * 4)
    bundle = dataclasses.replace(bundle, embedding=small)
    assert len(small.storage) > 3
    return bundle, create_train_state(bundle, seed=0)


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)
    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("ids_per_feature", [1, 5])
def test_predict_step_makes_one_grouped_k2_call_and_no_sequence_gather(
        staytime, monkeypatch, ids_per_feature):
    """With 1 id a call folds every single-id segment in one grouped K2
    call; with 5 ids that call is empty.  Either way no member is a
    sequence: the three DIN pools gather their rows from handles."""
    bundle, state = staytime
    eng = bundle.embedding
    batch = synthetic_batch(bundle, 12, seed=3, ids_per_feature=ids_per_feature)[0]
    plans = packed.plan_segments(eng, batch)
    single = sorted(seg.size for segs in plans.values() for seg in segs
                    if seg.kind == "mean" and seg.l == 1)
    assert sum(seg.kind == "seq" for segs in plans.values() for seg in segs) == 3
    rows_calls = _spy(monkeypatch, packed, "fold_rows_group")
    mean_calls = _spy(monkeypatch, packed, "fold_mean_group")
    gathers = _spy(monkeypatch, port_din, "din_pool_gather")
    out = make_predict_step(bundle)(state, batch)
    assert len(rows_calls) == 1 and len(mean_calls) == 1
    (members,), _ = rows_calls[0]
    assert sorted(ids.shape[0] for _, ids, _ in members) == single
    assert len(single) == (len(eng.storage) if ids_per_feature == 1 else 0)
    assert len(gathers) == 3
    for args, _ in gathers:
        table, ids, mask, lanes = args[1:5]
        assert ids.shape == (12, 5) and mask.shape == (12, 5) and lanes == (0, 16)
    assert all(torch.isfinite(v).all() for v in out.values())
