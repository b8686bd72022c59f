"""The sharded checkpoint and the multi-host input path, on 2 gloo ranks.

``fit(mode="sharded", checkpoint_dir=, checkpoint_every=2)`` on each rank
(``torch_sharded_worker.py``) saves the whole state gathered from the
ranks' shards, as orbax saves a sharded JAX state's global arrays:

- autoint (1-D mesh, data 2): the checkpoint restored in this process
  onto a local state equals the state the ranks gather, bit for bit; restored
  onto the ranks, it equals their shards; a local checkpoint restored onto
  the ranks equals ``shard_state`` of it; ``fit(resume=True)`` from the
  step-2 checkpoint gives the losses of steps 3 and 4 of an uninterrupted
  run (no dropout: a resumed ``fit`` draws its seeds afresh, as the JAX
  one does);
- ctr on a data 1 x model 2 mesh with ``tensor_parallel=True``: the column
  shards round-trip the same ways;
- the counterpart of ``tests/test_multihost.py``: each rank builds each
  global batch and keeps its own rows (``local_batch``, as
  ``multihost_worker.py`` feeds process-local data); the printed losses
  are the same string on both ranks.

One spawn of 2 ranks runs every case.
"""

import pytest
import torch

from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.train import create_train_state
from recommendsystem_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from torch_sharded_common import NO_DROPOUT, port_batch, run_ranks

torch.set_num_threads(1)
N = 2
AUTOINT = dict(bucket_size=64, model_param=NO_DROPOUT)
CTR = dict(bucket_size=128, attention_dropout_rate=0.0)


def _batches(model, kw, shards, n, b=8 * N):
    bundle = create_model(model, device="cpu", num_shards=shards, **kw)
    return [port_batch(*synthetic_batch(bundle, b, seed=s)) for s in range(n)]


def _same(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return a == b


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    local = create_train_state(create_model("autoint", device="cpu", num_shards=N, **AUTOINT),
                               seed=5)
    save_checkpoint(str(tmp / "local"), local)
    batches = _batches("autoint", AUTOINT, N, 4)
    cases = [
        {"kind": "fit", "model": "autoint", "kwargs": AUTOINT, "batches": batches,
         "steps": 2, "every": 2, "dir": str(tmp / "a"), "resume": 2,
         "local_dir": str(tmp / "local"),
         "local_state": {"params": local.params, "opt_state": local.opt_state,
                         "tables": local.tables, "step": local.step}},
        {"kind": "fit", "model": "autoint", "kwargs": AUTOINT, "batches": batches,
         "steps": 4, "every": 2, "dir": str(tmp / "b")},
        {"kind": "fit", "model": "ctr", "kwargs": CTR, "batches": _batches("ctr", CTR, 1, 2),
         "steps": 2, "every": 2, "dir": str(tmp / "c"), "model_parallel": N,
         "tensor_parallel": True},
        {"kind": "multihost", "model": "autoint", "kwargs": dict(bucket_size=64 * N),
         "steps": 3, "global_batch": 8 * N},
    ]
    results = run_ranks(N, cases, tmp)
    return tmp, dict(zip(("autoint", "uninterrupted", "tp", "multihost"), results))


@pytest.mark.parametrize("name,model,kw,shards", [("autoint", "autoint", AUTOINT, N),
                                                  ("tp", "ctr", CTR, 1)])
def test_sharded_checkpoint_restores_locally_bit_for_bit(group, name, model, kw, shards):
    tmp, results = group
    r = results[name]
    target = create_train_state(create_model(model, device="cpu", num_shards=shards, **kw),
                                seed=1)
    got = restore_checkpoint(str(tmp / {"autoint": "a", "tp": "c"}[name]), target)
    assert got.step == 2 == r["state"]["step"]
    assert _same({"params": got.params, "opt_state": got.opt_state, "tables": got.tables},
                 {k: r["state"][k] for k in ("params", "opt_state", "tables")})


@pytest.mark.parametrize("name", ["autoint", "tp"])
def test_sharded_checkpoint_restores_onto_the_ranks_bit_for_bit(group, name):
    _, results = group
    assert results[name]["restored_equal"]


def test_local_checkpoint_restores_onto_the_ranks_as_shard_state(group):
    _, results = group
    assert results["autoint"]["local_restored_equal"]


def test_resume_gives_the_uninterrupted_runs_losses(group):
    _, results = group
    assert len(results["autoint"]["resumed_losses"]) == 2
    assert results["autoint"]["resumed_losses"] == results["uninterrupted"]["losses"][2:]
    assert results["autoint"]["losses"] == results["uninterrupted"]["losses"][:2]


def test_each_rank_feeding_its_rows_prints_the_same_losses(group):
    _, results = group
    lines = results["multihost"]
    assert [line.split(" losses")[0] for line in lines] == [f"WORKER {r}" for r in range(N)]
    losses = [line.split("losses")[1].split() for line in lines]
    assert losses[0] == losses[1]
    assert len(losses[0]) == 3 and all(float(x) > 0 for x in losses[0])
