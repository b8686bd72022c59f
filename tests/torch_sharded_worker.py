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
- ``"layer"``: a stacked MoE layer (``layer`` "mmoe" or "ple", ``kwargs``,
  ``params`` its whole state dict) with its experts split over a model
  axis of WORLD (``expert_shardings``): the forward of ``x`` and the
  backward of ``cotangents``, giving the outputs, x's gradient and every
  parameter's gradient gathered whole.
- ``"column_dense"``: a ``Dense`` with its ``kernel`` split by columns
  over a model axis of WORLD (``bias``, ``x``, ``cotangent`` whole, in
  their types): the output, x's gradient and the kernel's gathered whole.
- ``"fit"``: ``harness.fit(mode="sharded", checkpoint_dir=, ...)`` (see
  ``_fit``); ``"multihost"``: each rank builds its rows of each global
  batch and steps (see ``_multihost``).

Train, predict and eval cases take ``model_parallel`` (the mesh's model
axis, default 1), ``tensor_parallel`` (``state_shardings(...,
tensor_parallel=True)``, with ``tp_min_dim`` where given) and ``experts``
(``nn.expert_shardings`` merged); a train case on such a mesh also gives
each placement's kind, the shards' shapes after the steps, whether the
model replicas' tables are equal and each step's
``model_axis.collective_stats()``.  A train case with ``record_grads``
also gives each step's dense gradients as the dense Adam takes them, the
split ones gathered whole.
"""

import dataclasses
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from recommendsystem_tpu_torch.core import model_axis  # noqa: E402
from recommendsystem_tpu_torch.core.model_axis import all_gather  # noqa: E402
from recommendsystem_tpu_torch.core.mesh import (column_sharding, create_mesh,  # noqa: E402
                                                 local_batch)
from recommendsystem_tpu_torch.data.loader import shard_files  # noqa: E402
from recommendsystem_tpu_torch.embedding.engine import (IdBatch,  # noqa: E402
                                                         all_to_all_lookup,
                                                         route_grads_to_owners)
from recommendsystem_tpu_torch.models import create_model  # noqa: E402
from recommendsystem_tpu_torch.nn import (Dense, MMOEStacked, PLEStacked,  # noqa: E402
                                          expert_shardings)
from recommendsystem_tpu_torch.train import metrics as M  # noqa: E402
from recommendsystem_tpu_torch.train.state import (TrainState, gather_state,  # noqa: E402
                                                   merge_shardings, shard_state,
                                                   state_shardings)
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


def _shardings(case, bundle, whole, mesh):
    """The case's placements of ``whole``: None (rows split, the rest
    replicated), or with the model axis's split leaves."""
    if not (case.get("tensor_parallel") or case.get("experts")):
        return None
    sh = state_shardings(bundle, whole, mesh, tensor_parallel=bool(case.get("tensor_parallel")),
                         tp_min_dim=case.get("tp_min_dim", 64))
    if case.get("experts"):
        sh = merge_shardings(sh, expert_shardings(whole.params, mesh))
    return sh


def _replicas_equal(tables, mesh):
    """Whether every model rank of this data index holds the same bits in
    every table leaf, on every rank."""
    mine = torch.cat([t.reshape(-1).view(torch.uint8) for s in tables.values()
                      for t in (s["w"], *s["opt"].values(), s["show"])])
    parts = [torch.empty_like(mine) for _ in range(mesh.model)]
    dist.all_gather(parts, mine, group=mesh.model_group)
    same = torch.tensor([float(all(torch.equal(p, mine) for p in parts))])
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same.item())


def _recording(bundle, sh, mesh, grads):
    """``bundle`` with a dense optimizer that appends each step's gradients
    to ``grads`` (a split one gathered whole over the model group), then
    updates as the bundle's does."""
    opt = bundle.dense_optimizer

    class Recorder:
        def init(self, params):
            return opt.init(params)

        def update_(self, params, gp, state):
            grads.append({k: all_gather(g, sh.params[k].dim, mesh.model_group, mesh.model)
                          if sh is not None and sh.params[k].model_axis else g.clone()
                          for k, g in gp.items()})
            return opt.update_(params, gp, state)

    return dataclasses.replace(bundle, dense_optimizer=Recorder())


def _train(case, mesh):
    bundle = _bundle(case, mesh.size)
    upd = case.get("sparse_update")
    whole = _state(case["state"])
    sh = _shardings(case, bundle, whole, mesh)
    state = shard_state(bundle, whole, mesh, sh)
    out = {"infos": [], "reports": [], "collectives": [], "grads": []}
    stepped = _recording(bundle, sh, mesh, out["grads"]) if case.get("record_grads") else bundle
    step = make_train_step(stepped, mode="sharded", sparse_update=upd, mesh=mesh, shardings=sh)
    for item, seed in zip(case["batches"], case["seeds"]):
        batch, labels, weight, dense = local_batch(_batch(item), mesh)
        if case.get("report"):
            out["reports"].append(bundle.embedding.a2a_drop_report(batch, mesh))
        model_axis.reset_collective_stats()
        state, info = step(state, batch, labels, weight, dense, seed=seed)
        out["collectives"].append(model_axis.collective_stats())
        out["infos"].append({k: float(v) for k, v in info.items()})
    if mesh.model > 1:
        out["placements"] = {} if sh is None else {k: p.kind for k, p in sh.params.items()}
        out["shard_shapes"] = {k: tuple(v.shape) for k, v in state.params.items()}
        out["replicas_equal"] = _replicas_equal(state.tables, mesh)
    out["state"] = _as_dict(gather_state(bundle, state, mesh, sh))
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
    whole = _state(case["state"])
    sh = _shardings(case, bundle, whole, mesh)
    state = shard_state(bundle, whole, mesh, sh)
    batch, labels, weight, dense = local_batch(_batch(case["batches"][0]), mesh)
    if case["kind"] == "predict":
        outs = make_predict_step(bundle, mode="sharded", mesh=mesh, shardings=sh)(
            state, batch, dense)
        return _gather_all({k: v.float() for k, v in outs.items()}, mesh)
    step = make_eval_step(bundle, mode="sharded", mesh=mesh, shardings=sh)
    states = M.init_metrics(bundle.metrics, mesh.device)
    states, _ = step(state, batch, labels, weight, dense, states)
    return {t: {n: float(v) for n, v in ms.items()}
            for t, ms in M.compute_metrics(bundle.metrics, states).items()}


def _layer(case, mesh):
    """A stacked MoE layer with its experts split over the model axis."""
    cls = {"mmoe": MMOEStacked, "ple": PLEStacked}[case["layer"]]
    layer = cls(device="cpu", **case["kwargs"])
    whole = case["params"]
    sh = expert_shardings(whole, mesh)
    params = {k: sh[k].local_part(v).clone().requires_grad_() for k, v in whole.items()}
    x = case["x"].clone().requires_grad_()
    with model_axis.use(mesh):
        outs = torch.func.functional_call(layer, params, (x,))
    torch.autograd.backward(outs, case["cotangents"])
    grads = {k: all_gather(p.grad, sh[k].dim, mesh.model_group, mesh.model)
             if sh[k].model_axis else p.grad for k, p in params.items()}
    return {"outputs": [o.detach() for o in outs], "x_grad": x.grad, "grads": grads,
            "kinds": {k: p.kind for k, p in sh.items()}}


def _column_dense(case, mesh):
    """A ``Dense`` (``in_features``, ``features``) whose kernel is split by
    columns over the model axis, in ``dtype``: the forward of ``x`` and the
    backward of ``cotangent``, giving the output, x's gradient and the
    kernel's gradient gathered whole."""
    layer = Dense(case["kernel"].shape[0], case["kernel"].shape[1], device="cpu")
    col = column_sharding(mesh)
    params = {"kernel": col.local_part(case["kernel"]).clone().requires_grad_(),
              "bias": case["bias"].clone().requires_grad_()}
    x = case["x"].clone().requires_grad_()
    with model_axis.use(mesh):
        out = torch.func.functional_call(layer, params, (x,))
    out.backward(case["cotangent"])
    return {"output": out.detach(), "x_grad": x.grad,
            "kernel_grad": all_gather(params["kernel"].grad, 1, mesh.model_group, mesh.model)}


def _same(a, b):
    """Whether two nests of dicts hold equal tensors bit for bit (and equal
    other leaves)."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return a == b


def _fit(case, mesh):
    """``fit(mode="sharded")`` over the case's whole batches (each rank
    its rows) for ``steps`` steps with a checkpoint every ``every`` under
    ``dir``: the losses, the whole state gathered, and whether the
    checkpoint restored onto the ranks equals their shards.  With
    ``resume`` (a number of steps), ``fit(resume=True)`` from that
    checkpoint over the batches after it, and the losses of those steps.
    With ``local_dir`` (a local checkpoint of the whole state
    ``local_state``), whether it restored onto the ranks equals
    ``shard_state`` of it."""
    from recommendsystem_tpu_torch.train.checkpoint import restore_checkpoint
    from recommendsystem_tpu_torch.train.harness import fit
    from recommendsystem_tpu_torch.train.state import create_train_state

    bundle = _bundle(case, mesh.size)
    sh = _shardings(case, bundle, create_train_state(bundle, seed=0), mesh)
    data = [local_batch(_batch(item), mesh) for item in case["batches"]]
    data = [(b, d, l, w) for b, l, w, d in data]
    out = {"losses": []}

    def run(items, steps, losses, **kw):
        return fit(bundle, items, steps=steps, seed=case.get("seed", 0), mesh=mesh,
                   mode="sharded", log_every=0, shardings=sh,
                   callbacks=[lambda i, st, info: losses.append(float(info["loss"]))], **kw)

    state = run(data, case["steps"], out["losses"], checkpoint_dir=case["dir"],
                checkpoint_every=case["every"])
    out["state"] = _as_dict(gather_state(bundle, state, mesh, sh))
    out["restored_equal"] = _same(
        _as_dict(restore_checkpoint(case["dir"], state, mesh=mesh, shardings=sh)),
        _as_dict(state))
    if case.get("resume"):
        out["resumed_losses"] = []
        run(data[case["resume"]:], None, out["resumed_losses"], checkpoint_dir=case["dir"],
            resume=True)
    if case.get("local_dir"):
        whole = _state(case["local_state"])
        out["local_restored_equal"] = _same(
            _as_dict(restore_checkpoint(case["local_dir"], state, mesh=mesh, shardings=sh)),
            _as_dict(shard_state(bundle, whole, mesh, sh)))
    return out


def _multihost(case, mesh):
    """The multihost worker's steps (``tests/multihost_worker.py``): each
    rank builds each global batch from its seed and keeps its own rows
    (``local_batch``); every rank's printed losses."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.train.state import create_train_state

    bundle = _bundle(case, mesh.size)
    state = shard_state(bundle, create_train_state(bundle, seed=0), mesh)
    step = make_train_step(bundle, mode="sharded", mesh=mesh)
    losses = []
    for i in range(case["steps"]):
        batch, _, labels, weight = synthetic_batch(bundle, case["global_batch"], seed=i)
        batch, labels, weight = local_batch((batch, labels, weight), mesh)
        state, info = step(state, batch, labels, weight, None, seed=i)
        losses.append(float(info["loss"]))
    line = f"WORKER {dist.get_rank()} losses {' '.join('%.6f' % v for v in losses)}"
    lines = [None] * dist.get_world_size()
    dist.all_gather_object(lines, line)
    return lines


def _files(case, mesh):
    out = [None] * mesh.size
    dist.all_gather_object(out, shard_files(case["files"]), group=mesh.group)
    return out


def main():
    rank, world, store, cases_path, out_path = sys.argv[1:6]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=int(world),
                            rank=int(rank))
    meshes = {}
    cases = torch.load(cases_path, weights_only=False)
    results = []
    try:
        for case in cases:
            m = case.get("model_parallel", 1)
            if m not in meshes:
                meshes[m] = create_mesh("cpu", model_parallel=m)
            run = {"train": _train, "exchange": _exchange, "predict": _serve,
                   "eval": _serve, "files": _files, "layer": _layer,
                   "column_dense": _column_dense, "fit": _fit,
                   "multihost": _multihost}[case["kind"]]
            results.append(run(case, meshes[m]))
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    if dist.get_rank() == 0:
        torch.save(results, out_path + ".part")
        os.replace(out_path + ".part", out_path)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
