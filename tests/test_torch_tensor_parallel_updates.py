"""The classic sparse updates and the bounded exchange under a model axis:
ctr (24 kernels column-split) on a data 2 x model 2 mesh of 4 gloo ranks,
against the JAX package's TP steps, as ``__graft_entry__.py:37-120`` runs
its 2-D step.

- ``sparse_update="scatter"`` and ``"dense"``: 3 port steps against 3 JAX
  TP steps of the same update (``torch_sharded_common.jax_tp_steps``), at
  ``torch_sharded_common``'s tolerances; the model replicas' tables bit
  for bit after them.
- The replicas' sync (``core.model_axis.sync_replicas``): the scatter
  step sends only the rows its update wrote, the rows of the rank's shard
  that a real id of the whole batch reached (``engine.row_counts``), and
  the dense step every row of the shard; each step's ``sync_bytes`` is
  that many rows of w, m, v, t and show.
- The packed step with ``a2a_capacity_factor = 2.0``: its drop report
  counts 0 rows, its losses are within 1e-4 of the exact exchange's, and
  its state equals the JAX TP steps'.

One spawn of 4 ranks runs every case.
"""

import pytest
import torch

from recommendsystem_tpu_torch.embedding.engine import IdBatch
from recommendsystem_tpu_torch.models import create_model
from test_torch_tensor_parallel import KW
from torch_sharded_common import assert_matches_jax, bridged_case, jax_tp_steps, run_ranks

torch.set_num_threads(1)
DATA, MODEL = 2, 2
SEEDS = [1, 2, 3]
CASES = {"scatter": ("scatter", {}), "dense": ("dense", {}),
         "bounded": ("packed", {"capacity": 2.0, "report": True})}


def _steps(jbundle, jstate, batches, n, upd):
    return jax_tp_steps(jbundle, jstate, batches, n, upd, model=MODEL)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    expected, cases = {}, []
    for name, (upd, extra) in CASES.items():
        jbundle, jstate, jinfos, case = bridged_case(
            "ctr", KW, DATA, 8 * DATA, seeds=SEEDS, sparse_update=upd, jax_steps=_steps,
            model_parallel=MODEL, tensor_parallel=True, **extra)
        expected[name] = (jbundle, jstate, jinfos)
        cases.append(case)
    exact = dict(cases[-1], sparse_update="packed")
    del exact["capacity"]
    cases.append(exact)
    results = run_ranks(DATA * MODEL, cases, tmp_path_factory.mktemp("tp_updates"))
    return expected, dict(zip(list(CASES) + ["exact"], results)), cases[0]


@pytest.mark.parametrize("name", list(CASES))
def test_three_tp_steps_match_the_jax_tp_steps(group, name):
    expected, results, _ = group
    r = results[name]
    assert_matches_jax(*expected[name], r)
    assert r["replicas_equal"]
    assert sum(v == "column" for v in r["placements"].values()) == 24


def _synced_rows(case, upd):
    """Each step's rows of rank 0's shards that ``upd`` syncs over the
    model group, and the bytes of one row of every storage."""
    bundle = create_model("ctr", device="cpu", num_shards=DATA, **KW)
    tables = case["state"]["tables"]
    row_bytes = {k: sum(x.element_size() * x[0].numel()
                        for x in (t["w"], *t["opt"].values(), t["show"]))
                 for k, t in tables.items()}
    steps = []
    for item in case["batches"]:
        batch = {k: IdBatch(rows=r, mask=m) for k, (r, m) in item["batch"].items()}
        counts = bundle.embedding.row_counts(batch)
        steps.append({k: (int((c[:c.shape[0] // DATA] > 0).sum()) if upd == "scatter"
                          else c.shape[0] // DATA) for k, c in counts.items()})
    return steps, row_bytes


@pytest.mark.parametrize("upd", ["scatter", "dense"])
def test_the_sync_sends_the_rows_the_update_wrote(group, upd):
    _, results, case = group
    steps, row_bytes = _synced_rows(case, upd)
    got = [c["sync_bytes"] for c in results[upd]["collectives"]]
    want = [sum(n * row_bytes[k] for k, n in rows.items()) for rows in steps]
    assert got == want
    assert all(c["sync_calls"] == 1 for c in results[upd]["collectives"])
    if upd == "scatter":
        dense = [c["sync_bytes"] for c in results["dense"]["collectives"]]
        assert all(s < d for s, d in zip(got, dense))


def test_bounded_exchange_drops_nothing_and_keeps_the_loss(group):
    _, results, _ = group
    r, exact = results["bounded"], results["exact"]
    assert len(r["reports"]) == len(SEEDS)
    assert all(sum(v["rows"] for v in rep.values()) == 0 for rep in r["reports"])
    for got, want in zip(r["infos"], exact["infos"]):
        assert abs(got["loss"] - want["loss"]) < 1e-4
    assert r["replicas_equal"] and exact["replicas_equal"]
