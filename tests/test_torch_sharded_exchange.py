"""The sharded exchange of the port against the JAX package's, and the
rest of the sharded mode on 4 gloo ranks.

- ``exchange_capacity`` and ``_owner_slots`` (which entries a bounded
  exchange drops: the same, in the same order) against the JAX functions;
- both exchanges at capacity factor 2.0 with hot-id skew (most ids owned
  by rank 0, padding ids 0 that take no capacity): ``all_to_all_lookup``
  and ``route_grads_to_owners`` on every rank against the JAX ones inside
  ``shard_map`` over 4 CPU devices;
- a one-slot autoint at factor 2.0 with the same skew, one step of each
  sparse update against the JAX sharded step, and ``a2a_drop_report
  ["rows"]`` against the JAX report's;
- ctr (six L1L2-penalized Dense layers) with sample weights uneven across
  the ranks: the loss, ``regularization`` and the dense gradients (Adam's
  first moments) against JAX;
- within the port, the sharded step with autoint's attention dropout 0.2
  against the local step on the whole batch (each rank numbers its
  samples from its first global one);
- a table of 2^18 rows a member: only the batch's rows and their state
  change (``tests/test_sharded_training.py:77-118``);
- ``shard_files``' defaults from the process group, and the mesh's
  one-rank group in this process: the JAX ``create_mesh``'s ``ValueError``
  for 1 rank over a model axis of 2, and ``tensor_parallel`` splitting
  nothing at a model axis of 1.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from recommendsystem_tpu.core import create_mesh as jax_create_mesh
from recommendsystem_tpu.core.config import synthetic_ctr_config as jax_synthetic_ctr_config
from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.embedding import engine as jeng
from recommendsystem_tpu_torch.core import mesh as pmesh
from recommendsystem_tpu_torch.core.config import synthetic_ctr_config
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.embedding import engine as peng
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.train import create_train_state, state_shardings
from torch_sharded_common import (NO_DROPOUT, PARAM_TOL, TABLE_TOL, assert_matches_jax,
                                  bridged_case, port_batch, run_ranks)

torch.set_num_threads(1)
N = 4
CAPACITY = 2.0
ONE_SLOT = (dict(cfg=synthetic_ctr_config(num_slots=1, emb_sizes=(8,), num_bias=0),
                 bucket_size=64, model_param=NO_DROPOUT),
            dict(cfg=jax_synthetic_ctr_config(num_slots=1, emb_sizes=(8,), num_bias=0),
                 bucket_size=64, model_param=NO_DROPOUT))
BIG_ROWS = 1 << 18
BIG = dict(cfg=synthetic_ctr_config(num_slots=2, emb_sizes=(8,), num_bias=0),
           bucket_size=BIG_ROWS)


def _hot(key, ids):
    """Four in five ids of a column replaced by one of 4 hot ids of rank
    0's rows."""
    rng = np.random.default_rng(sum(map(ord, key)))
    hot = rng.integers(0, 4, ids.shape).astype(ids.dtype)
    return np.where(rng.random(ids.shape) < 0.8, hot, ids)


def _exchange_inputs():
    rng = np.random.default_rng(5)
    e, d, rows = 48, 8, 64 * N
    ids = np.where(rng.random((N, e)) < 0.7, rng.integers(0, 8, (N, e)),
                   rng.integers(0, rows, (N, e))).astype(np.int32)
    mask = (rng.random((N, e)) < 0.8).astype(np.float32)
    ids = np.where(mask > 0, ids, 0).astype(np.int32)          # padding: id 0
    grads = rng.standard_normal((N, e, d)).astype(np.float32)
    table = rng.standard_normal((rows, d)).astype(np.float32)
    return ids, mask, grads, table


def _jax_exchange(ids, mask, grads, table):
    mesh = jax_create_mesh(jax.devices()[:N])
    d = table.shape[1]

    def body(w, r, m, g):
        r, m, g = r.reshape(-1), m.reshape(-1), g.reshape(-1, d)
        pulled = jeng.all_to_all_lookup(w, r, "data", CAPACITY, mask=m)
        rr, rg, rm = jeng.route_grads_to_owners(r, g, m, w.shape[0], "data", CAPACITY)
        return pulled[None], rr[None], rg[None], rm[None]

    fn = jax.shard_map(body, mesh=mesh, in_specs=(P("data", None), P("data"), P("data"),
                                                  P("data")),
                       out_specs=P("data"), check_vma=False)
    return [np.asarray(x) for x in fn(table, ids, mask, grads)]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    ids, mask, grads, table = _exchange_inputs()
    cases = [{"kind": "exchange", "rows": torch.from_numpy(ids),
              "mask": torch.from_numpy(mask), "grads": torch.from_numpy(grads),
              "table": torch.from_numpy(table), "capacity": CAPACITY}]
    expected = {"exchange": _jax_exchange(ids, mask, grads, table)}
    for upd in ("packed", "scatter", "dense"):
        jbundle, jstate, jinfos, case = bridged_case(
            "autoint", ONE_SLOT[0], N, 16 * N, seeds=[2], sparse_update=upd, jkw=ONE_SLOT[1],
            rows=_hot, capacity=CAPACITY, report=True)
        expected[upd] = (jbundle, jstate, jinfos)
        cases.append(case)
    weights = np.where(np.arange(8 * N) < 8, 3.0, 0.5).astype(np.float32)[:, None]
    weights *= np.random.default_rng(1).uniform(0.5, 1.5, weights.shape).astype(np.float32)
    jbundle, jstate, jinfos, case = bridged_case(
        "ctr", dict(bucket_size=128, attention_dropout_rate=0.0), N, 8 * N, seeds=[4],
        weights=weights)
    expected["weighted"] = (jbundle, jstate, jinfos)
    cases.append(case)
    # within the port: autoint's attention dropout 0.2, two steps
    cases.append(_port_case(dict(bucket_size=64), seeds=[5, 6], local=True))
    big = _port_case(BIG, seeds=[3])
    for upd in ("scatter", "packed"):
        cases.append(dict(big, sparse_update=upd))
    cases.append({"kind": "files", "files": [f"part-{i}" for i in range(10)]})
    results = run_ranks(N, cases, tmp_path_factory.mktemp("exchange"))
    names = ["exchange", "packed", "scatter", "dense", "weighted", "dropout",
             "big_scatter", "big_packed", "files"]
    return expected, dict(zip(names, results)), big


def _port_case(kw, seeds, **extra):
    """A port-only autoint case from ``create_train_state``, one batch a
    seed, step seeds 11, 12, ..."""
    bundle = create_model("autoint", device="cpu", num_shards=N, **kw)
    st = create_train_state(bundle, seed=0)
    return {"kind": "train", "model": "autoint", "kwargs": kw,
            "state": {"params": st.params, "opt_state": st.opt_state, "tables": st.tables,
                      "step": 0},
            "batches": [port_batch(*synthetic_batch(bundle, 8 * N, seed=s)) for s in seeds],
            "seeds": [11 + i for i in range(len(seeds))], **extra}


@pytest.mark.parametrize("e,n,factor,want", [
    (100, 4, None, 100), (100, 4, "auto", 100), (1024, 4, "auto", 512),
    (1000, 4, 2.0, 500), (7, 4, 2.0, 4), (3, 8, 2.0, 1), (10, 2, 2.0, 10)])
def test_exchange_capacity_is_the_jax_packages(e, n, factor, want):
    assert peng.exchange_capacity(e, n, factor) == jeng.exchange_capacity(e, n, factor) == want


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cap", [5, 12, 40])
def test_owner_slots_drop_the_jax_packages_entries(masked, cap):
    rng = np.random.default_rng(cap)
    rows = np.where(rng.random(40) < 0.6, rng.integers(0, 6, 40),
                    rng.integers(0, 64, 40)).astype(np.int32)
    mask = (rng.random(40) < 0.7).astype(np.float32) if masked else None
    want = jeng._owner_slots(jax.numpy.asarray(rows), 16, 4, cap,
                             None if mask is None else jax.numpy.asarray(mask))
    got = peng._owner_slots(torch.from_numpy(rows).long(), 16, 4, cap,
                            None if mask is None else torch.from_numpy(mask))
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_both_exchanges_drop_what_jax_drops(group):
    expected, results, _ = group
    pulled, rrows, rgrads, rmask = expected["exchange"]
    got = results["exchange"]
    assert (np.asarray(pulled) == 0).all(axis=-1).any()     # some entries were dropped
    for r in range(N):
        np.testing.assert_array_equal(got["pulled"][r].numpy(), pulled[r])
        np.testing.assert_array_equal(got["recv_rows"][r].numpy(), rrows[r])
        np.testing.assert_array_equal(got["recv_grads"][r].numpy(), rgrads[r])
        np.testing.assert_array_equal(got["recv_mask"][r].numpy(), rmask[r])


@pytest.mark.parametrize("update", ["packed", "scatter", "dense"])
def test_bounded_capacity_step_matches_jax(group, update):
    expected, results, _ = group
    jbundle, jstate, jinfos = expected[update]
    assert_matches_jax(jbundle, jstate, jinfos, results[update])


def test_drop_report_counts_the_jax_packages_rows(group):
    expected, results, _ = group
    jbundle = expected["packed"][0]
    jbatch = jax_synthetic_batch(jbundle, 16 * N, seed=2)[0]
    jbatch = {k: type(v)(rows=jax.numpy.asarray(_hot(k, np.asarray(v.rows))), mask=v.mask)
              for k, v in jbatch.items()}
    mesh = jax_create_mesh(jax.devices()[:N])
    data = NamedSharding(mesh, P("data"))
    jbatch = jax.device_put(jbatch, jax.tree.map(lambda _: data, jbatch))
    want = jbundle.embedding.a2a_drop_report(jbatch, mesh)
    got = results["packed"]["reports"][0]
    assert set(got) == set(want)
    assert sum(r["rows"] for r in got.values()) > 0
    for skey, rep in want.items():
        assert got[skey] == {"rows": rep["rows"]}


def test_uneven_weights_match_jax_loss_penalty_and_dense_gradients(group):
    expected, results, _ = group
    assert results["weighted"]["infos"][0]["regularization"] > 0
    assert_matches_jax(*expected["weighted"], results["weighted"])


def test_sharded_dropout_step_equals_the_local_step(group):
    _, results, _ = group
    r = results["dropout"]
    for got, want in zip(r["infos"], r["local_infos"]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    sh, lo = r["state"], r["local_state"]
    for k, v in lo["params"].items():
        np.testing.assert_allclose(sh["params"][k].numpy(), v.numpy(), **PARAM_TOL, err_msg=k)
    for skey, t in lo["tables"].items():
        np.testing.assert_allclose(sh["tables"][skey]["w"].numpy(), t["w"].numpy(),
                                   **TABLE_TOL, err_msg=skey)
        for name, v in t["opt"].items():
            np.testing.assert_allclose(sh["tables"][skey]["opt"][name].numpy(), v.numpy(),
                                       **TABLE_TOL, err_msg=f"{skey} {name}")
        np.testing.assert_array_equal(sh["tables"][skey]["show"].numpy(), t["show"].numpy())


@pytest.mark.parametrize("update", ["scatter", "packed"])
def test_large_table_step_touches_only_the_batch_rows(group, update):
    _, results, big = group
    before, item = big["state"], big["batches"][0]
    bundle = create_model("autoint", device="cpu", num_shards=N, **BIG)
    eng = bundle.embedding
    touched = {skey: set() for skey in eng.storage}
    for key, (rows, mask) in item["batch"].items():
        skey, off, _ = eng.table_map[eng.columns[key].categorical_column.key]
        touched[skey].update((rows[mask > 0] + off).tolist())
    for skey, t in results[f"big_{update}"]["state"]["tables"].items():
        assert t["w"].shape[0] >= BIG_ROWS
        old = before["tables"][skey]
        changed = set(torch.nonzero((t["w"] != old["w"]).any(1)).view(-1).tolist())
        assert changed and changed <= touched[skey], skey
        for name in ("m", "v", "t"):
            moved = set(torch.nonzero((t["opt"][name] != old["opt"][name]).any(1))
                        .view(-1).tolist())
            assert moved <= touched[skey], f"{skey} {name}"
        shown = set(torch.nonzero(t["show"].view(-1) != old["show"].view(-1)).view(-1).tolist())
        assert shown == touched[skey], skey


def test_shard_files_defaults_to_the_process_group(group):
    _, results, _ = group
    files = [f"part-{i}" for i in range(10)]
    assert results["files"] == [files[r::N] for r in range(N)]


def test_one_rank_mesh_and_its_refusals():
    assert not dist.is_initialized()
    assert pmesh.process_count() == 1 and pmesh.process_index() == 0
    # the JAX create_mesh's refusal: 1 device over a model axis of 2
    with pytest.raises(ValueError, match="1 devices not divisible by model_parallel=2"):
        pmesh.create_mesh("cpu", model_parallel=2)
    assert not dist.is_initialized()
    mesh = pmesh.create_mesh("cpu")
    try:
        assert (mesh.size, mesh.rank, mesh.shape) == (1, 0, {"data": 1, "model": 1})
        assert dist.get_backend() == "gloo"
        bundle = create_model("autoint", device="cpu", bucket_size=64)
        state = create_train_state(bundle, seed=0)
        sh = state_shardings(bundle, state, mesh)
        skey = next(iter(state.tables))
        assert sh.tables[skey]["w"].kind == "row" and sh.tables[skey]["opt"]["t"].kind == "row"
        assert {p.kind for p in sh.params.values()} == {"replicated"}
        # a model axis of 1 splits nothing (the JAX rule's tp_size 1)
        tp = state_shardings(bundle, state, mesh, tensor_parallel=True, tp_min_dim=1)
        assert {p.kind for p in tp.params.values()} == {"replicated"}
        assert {p.kind for m in ("mu", "nu") for p in tp.opt_state[m].values()} == {
            "replicated"}
        assert (mesh.model, mesh.model_group, mesh.model_rank) == (1, None, 0)
        assert pmesh.local_mesh(1) is not None
    finally:
        dist.destroy_process_group()
