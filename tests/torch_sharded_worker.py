"""One rank of the port's sharded mode on the CPU, for the sharded tests.

    python tests/torch_sharded_worker.py RANK WORLD STORE CASES OUT

joins a gloo process group of WORLD ranks through the file STORE, loads
the cases that the test wrote to CASES (``torch.save`` of a list of dicts),
runs each on this rank's shards and rows, and rank 0 writes what each case
gave to OUT.  It imports the port alone (never JAX), so that the spawned
ranks stay small.  Each case is a dict with ``"kind"``:

- ``"train"``: ``model`` and ``kwargs`` build the bundle on the CPU with
  ``num_shards=WORLD``; ``state`` is the whole state (``params``,
  ``opt_state``, ``tables``, ``step``), ``batches`` a list of whole
  batches (``batch`` {column: (rows, mask)}, ``labels``, ``weight``,
  ``dense``), ``seeds`` one step seed each; optional ``sparse_update``,
  ``capacity`` (the engine's ``a2a_capacity_factor``), ``no_dropout``
  (the InteractingLayer's ``use_dropout`` set False), ``local`` (also take
  the local step on the whole batch, on every rank) and ``report`` (the
  ``a2a_drop_report`` of each batch).  Gives the infos, the whole state
  gathered back (``gather_state``) and, with ``local``, the local step's.
- ``"exchange"``: ``rows`` (WORLD, E) global rows, ``mask`` (WORLD, E),
  ``grads`` (WORLD, E, D), ``table`` the whole (R, D) table and
  ``capacity``: rank r pulls its rows (``all_to_all_lookup``) and pushes
  its grads (``route_grads_to_owners``); gives every rank's results.
- ``"predict"``, ``"eval"``: a predict call or an eval step on the
  sharded state, giving every rank's outputs (and the metric values).
- ``"files"``: ``data.loader.shard_files(files)`` with its defaults,
  every rank's list.
"""

import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from recommendsystem_tpu_torch.core.mesh import create_mesh, local_batch  # noqa: E402
from recommendsystem_tpu_torch.data.loader import shard_files  # noqa: E402
from recommendsystem_tpu_torch.embedding.engine import (IdBatch,  # noqa: E402
                                                         all_to_all_lookup,
                                                         route_grads_to_owners)
from recommendsystem_tpu_torch.models import create_model  # noqa: E402
from recommendsystem_tpu_torch.train import metrics as M  # noqa: E402
from recommendsystem_tpu_torch.train.state import (TrainState, gather_state,  # noqa: E402
                                                   shard_state)
from recommendsystem_tpu_torch.train.step import (make_eval_step,  # noqa: E402
                                                  make_predict_step, make_train_step)


def _clone(x):
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x.clone() if isinstance(x, torch.Tensor) else x


def _state(d):
    return TrainState(params=_clone(d["params"]), opt_state=_clone(d["opt_state"]),
                      tables=_clone(d["tables"]), step=d["step"])


def _as_dict(state):
    return {"params": state.params, "opt_state": state.opt_state,
            "tables": state.tables, "step": state.step}


def _batch(item):
    return ({k: IdBatch(rows=r, mask=m) for k, (r, m) in item["batch"].items()},
            item["labels"], item.get("weight"), item.get("dense"))


def _bundle(case, world):
    bundle = create_model(case["model"], device="cpu", num_shards=world,
                          **case.get("kwargs", {}))
    if case.get("no_dropout"):
        bundle.module.interacting.use_dropout = False
    if "capacity" in case:
        bundle.embedding.a2a_capacity_factor = case["capacity"]
    return bundle


def _train(case, mesh):
    bundle = _bundle(case, mesh.size)
    upd = case.get("sparse_update")
    whole = _state(case["state"])
    state = shard_state(bundle, whole, mesh)
    step = make_train_step(bundle, mode="sharded", sparse_update=upd, mesh=mesh)
    out = {"infos": [], "reports": []}
    for item, seed in zip(case["batches"], case["seeds"]):
        batch, labels, weight, dense = local_batch(_batch(item), mesh)
        if case.get("report"):
            out["reports"].append(bundle.embedding.a2a_drop_report(batch, mesh))
        state, info = step(state, batch, labels, weight, dense, seed=seed)
        out["infos"].append({k: float(v) for k, v in info.items()})
    out["state"] = _as_dict(gather_state(bundle, state, mesh))
    if case.get("local"):
        local = make_train_step(bundle, sparse_update=upd)
        lstate, out["local_infos"] = whole, []
        for item, seed in zip(case["batches"], case["seeds"]):
            batch, labels, weight, dense = _batch(item)
            lstate, info = local(lstate, batch, labels, weight, dense, seed=seed)
            out["local_infos"].append({k: float(v) for k, v in info.items()})
        out["local_state"] = _as_dict(lstate)
    return out


def _exchange(case, mesh):
    r = mesh.rank
    table = case["table"]
    local = table[mesh.rows(table.shape[0])]
    rows, mask, grads = case["rows"][r], case["mask"][r], case["grads"][r]
    pulled = all_to_all_lookup(local, rows, mesh, case["capacity"], mask)
    recv = route_grads_to_owners(rows, grads, mask, local.shape[0], mesh, case["capacity"])
    return _gather_all({"pulled": pulled, "recv_rows": recv[0], "recv_grads": recv[1],
                        "recv_mask": recv[2]}, mesh)


def _gather_all(d, mesh):
    """{name: [every rank's tensor]} (each rank's of one shape)."""
    out = {}
    for k, t in d.items():
        parts = [torch.empty_like(t) for _ in range(mesh.size)]
        dist.all_gather(parts, t.contiguous(), group=mesh.group)
        out[k] = parts
    return out


def _serve(case, mesh):
    bundle = _bundle(case, mesh.size)
    state = shard_state(bundle, _state(case["state"]), mesh)
    batch, labels, weight, dense = local_batch(_batch(case["batches"][0]), mesh)
    if case["kind"] == "predict":
        outs = make_predict_step(bundle, mode="sharded", mesh=mesh)(state, batch, dense)
        return _gather_all({k: v.float() for k, v in outs.items()}, mesh)
    step = make_eval_step(bundle, mode="sharded", mesh=mesh)
    states = M.init_metrics(bundle.metrics, mesh.device)
    states, _ = step(state, batch, labels, weight, dense, states)
    return {t: {n: float(v) for n, v in ms.items()}
            for t, ms in M.compute_metrics(bundle.metrics, states).items()}


def _files(case, mesh):
    out = [None] * mesh.size
    dist.all_gather_object(out, shard_files(case["files"]), group=mesh.group)
    return out


def main():
    rank, world, store, cases_path, out_path = sys.argv[1:6]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=int(world),
                            rank=int(rank))
    mesh = create_mesh("cpu")
    cases = torch.load(cases_path, weights_only=False)
    results = []
    try:
        for case in cases:
            run = {"train": _train, "exchange": _exchange, "predict": _serve,
                   "eval": _serve, "files": _files}[case["kind"]]
            results.append(run(case, mesh))
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    if mesh.rank == 0:
        torch.save(results, out_path + ".part")
        os.replace(out_path + ".part", out_path)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
