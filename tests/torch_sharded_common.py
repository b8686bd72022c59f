"""Shared pieces of the sharded tests (``tests/test_torch_sharded*.py``):
the JAX package's sharded step on the CPU mesh, bridged cases for the
port's ranks, and the spawn of those ranks (``torch_sharded_worker.py``,
gloo over a ``FileStore`` under the test's ``tmp_path``, so that xdist
workers share no port).

A case starts from one JAX state: the JAX bundle built with
``num_shards=n`` takes ``steps`` sharded steps on ``create_mesh(jax.devices()
[:n])`` (state placed by ``state_shardings``, batch by ``P("data")``), and
the same state, carried across by ``bridge.from_jax_numpy``, goes to the
port's n ranks with the same batches.  Rank 0 gathers the port's state
back (``gather_state``); ``assert_matches_jax`` holds it to the JAX state
at the tolerances of ``tests/test_sharded_training.py:46-76``: loss rtol
1e-5; params rtol 5e-4, atol 1e-5; tables and moments rtol 5e-4, atol
1e-6; show and t exact.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from recommendsystem_tpu.core import create_mesh as jax_create_mesh
from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train import state_shardings as jax_state_shardings
from recommendsystem_tpu.train.step import make_train_step as jax_make_train_step
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.models import create_model
from test_torch_autoint_train import _flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_sharded_worker.py")
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)
TABLE_TOL = dict(rtol=5e-4, atol=1e-6)
ZERO_MU = 1e-9
NO_DROPOUT = {"interact": {"layer_num": 1, "unit_num": 8, "head_num": 2,
                           "use_dropout": False, "dropout_rate": 0.2,
                           "use_res": True}}


def run_ranks(n, cases, tmp_path, timeout=600):
    """Runs ``cases`` on n port ranks (one process each, torch pinned to
    one thread); returns rank 0's results, one a case."""
    d = tmp_path / f"ranks{n}"
    d.mkdir(exist_ok=True)
    torch.save(cases, d / "cases.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(n), str(d / "store"),
                               str(d / "cases.pt"), str(d / "out.pt")],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err)
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)[-4000:]
    return torch.load(d / "out.pt", weights_only=False)


def jax_sharded_steps(jbundle, jstate, batches, n, sparse_update="packed"):
    """The JAX state after one sharded step a batch (``batches``: (batch,
    dense, labels, weight) each, step i keyed ``PRNGKey(i)``) on the first
    n CPU devices, and each step's info."""
    mesh = jax_create_mesh(jax.devices()[:n])
    data = NamedSharding(mesh, P("data"))
    put = lambda x: None if x is None else jax.device_put(  # noqa: E731
        x, jax.tree.map(lambda _: data, x))
    state = jax.device_put(jstate, jax_state_shardings(jbundle, jstate, mesh))
    step = jax_make_train_step(jbundle, mesh=mesh, mode="sharded", donate=False,
                               sparse_update=sparse_update)
    infos = []
    for i, (b, d, l, w) in enumerate(batches):
        state, info = step(state, put(b), put(l), put(w), put(d), jax.random.PRNGKey(i))
        infos.append({k: float(v) for k, v in jax.device_get(info).items()})
    return state, infos


def jax_tp_steps(jbundle, jstate, batches, n, sparse_update="packed", model=2, record=None,
                 tp_min_dim=64):
    """The JAX package's tensor-parallel steps, as ``tests/test_tensor_parallel.py``
    takes them: the state placed by ``state_shardings(tensor_parallel=True,
    tp_min_dim=tp_min_dim)`` on a ``create_mesh(jax.devices()[:n * model],
    model_parallel=model)`` mesh (data n x model), each batch by
    ``P("data")``, and the local train step (XLA inserts the model axis's
    collectives), step i keyed ``PRNGKey(i)``.  ``record``, where given,
    gets the mesh and the placements."""
    mesh = jax_create_mesh(jax.devices()[:n * model], model_parallel=model)
    data = NamedSharding(mesh, P("data"))
    put = lambda x: None if x is None else jax.device_put(  # noqa: E731
        x, jax.tree.map(lambda _: data, x))
    sh = jax_state_shardings(jbundle, jstate, mesh, tensor_parallel=True, tp_min_dim=tp_min_dim)
    if record is not None:
        record.update(mesh=mesh, shardings=sh)
    state = jax.device_put(jstate, sh)
    step = jax_make_train_step(jbundle, donate=False, sparse_update=sparse_update)
    infos = []
    for i, (b, d, l, w) in enumerate(batches):
        state, info = step(state, put(b), put(l), put(w), put(d), jax.random.PRNGKey(i))
        infos.append({k: float(v) for k, v in jax.device_get(info).items()})
    return state, infos


def port_batch(batch, dense, labels, weight):
    """A port batch as the worker takes it."""
    return {"batch": {k: (v.rows, v.mask) for k, v in batch.items()},
            "labels": labels, "weight": weight, "dense": dense}


def bridged_case(model, kw, n, batch_size, seeds, sparse_update="packed", key=0,
                 ids_per_feature=5, weights=None, jkw=None, rows=None,
                 jax_steps=jax_sharded_steps, **extra):
    """(JAX bundle, JAX state after the steps, JAX infos, the port's case):
    one JAX state for ``model`` built with ``kw`` (``jkw`` on the JAX side
    where it differs) and ``num_shards=n``, one step a batch seed of
    ``seeds`` (by ``jax_steps``: the JAX sharded step over n devices, or
    for example ``jax_tp_steps``); ``weights``, where given, replaces each
    batch's sample weights on both sides, and ``rows(key, ids)`` each
    column's (B, L) ids (numpy)."""
    jbundle = jax_create_model(model, num_shards=n, **(kw if jkw is None else jkw))
    pbundle = create_model(model, device="cpu", num_shards=n, **kw)
    jbatches, pbatches = [], []
    for s in seeds:
        jb, jd, jl, jw = jax_synthetic_batch(jbundle, batch_size, seed=s,
                                             ids_per_feature=ids_per_feature)
        pb, pd, pl, pw = synthetic_batch(pbundle, batch_size, seed=s,
                                         ids_per_feature=ids_per_feature)
        if weights is not None:
            jw, pw = weights, torch.tensor(np.asarray(weights))
        if rows is not None:
            for k in pb:
                ids = rows(k, pb[k].rows.numpy())
                pb[k] = dataclasses.replace(pb[k], rows=torch.from_numpy(ids))
                jb[k] = dataclasses.replace(jb[k], rows=jax.numpy.asarray(ids))
        jbatches.append((jb, jd, jl, jw))
        pbatches.append(port_batch(pb, pd, pl, pw))
    jb, jd = jbatches[0][:2]
    jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(key), jb, dense_inputs=jd)
    pstate = bridge.from_jax_numpy(
        pbundle, jax.tree.map(np.asarray, jstate.params),
        jax.device_get(jbundle.embedding.classic_state(jstate.tables)),
        opt_state=jax.tree.map(np.asarray, jstate.opt_state))
    if "capacity" in extra:
        jbundle.embedding.a2a_capacity_factor = extra["capacity"]
    jstate, jinfos = jax_steps(jbundle, jstate, jbatches, n, sparse_update)
    case = {"kind": "train", "model": model, "kwargs": kw, "sparse_update": sparse_update,
            "state": {"params": pstate.params, "opt_state": pstate.opt_state,
                      "tables": pstate.tables, "step": 0},
            "batches": pbatches, "seeds": list(range(len(seeds))), **extra}
    return jbundle, jstate, jinfos, case


def assert_matches_jax(jbundle, jstate, jinfos, result, zero_grad=()):
    """The port's gathered state and infos against the JAX sharded step's.
    ``zero_grad`` names params whose gradient is 0 in exact arithmetic
    (staytime's DIN ``b2``, ``tests/test_torch_staytime_train.py``): Adam
    moves each package's by its own rounding noise, so an entry of one
    past PARAM_TOL passes only where both packages' first moments of it
    are within ZERO_MU of 0."""
    assert len(result["infos"]) == len(jinfos)
    for i, (got, want) in enumerate(zip(result["infos"], jinfos)):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=f"step {i} {k}")
    port = result["state"]
    jc = jax.device_get(jbundle.embedding.classic_state(jstate.tables))
    assert set(jc) == set(port["tables"])
    for skey, want in jc.items():
        got = port["tables"][skey]
        np.testing.assert_allclose(got["w"].float().numpy(),
                                   np.asarray(want["w"], np.float32), **TABLE_TOL,
                                   err_msg=f"{skey} w")
        np.testing.assert_array_equal(got["show"].numpy(), want["show"], err_msg=skey)
        for name, t in want["opt"].items():
            g = got["opt"][name].float().numpy()
            if name == "t":
                np.testing.assert_array_equal(g, t, err_msg=f"{skey} t")
            else:
                np.testing.assert_allclose(g, np.asarray(t, np.float32), **TABLE_TOL,
                                           err_msg=f"{skey} {name}")
    jp = _flat(jax.device_get(jstate.params))
    jmu = _flat(jax.device_get(jstate.opt_state[0].mu))
    assert set(jp) == set(port["params"])
    for k, v in jp.items():
        got = port["params"][k].numpy()
        if k in zero_grad:
            past = ~np.isclose(got, v, **PARAM_TOL)
            for m in (jmu[k][past], port["opt_state"]["mu"][k].numpy()[past]):
                np.testing.assert_array_less(np.abs(m), ZERO_MU, err_msg=k)
            got, v = got[~past], v[~past]
        np.testing.assert_allclose(got, v, **PARAM_TOL, err_msg=k)
    for k, v in jmu.items():
        np.testing.assert_allclose(port["opt_state"]["mu"][k].numpy(), v, **TABLE_TOL,
                                   err_msg=f"mu {k}")
    assert port["opt_state"]["count"] == int(jstate.opt_state[0].count)
