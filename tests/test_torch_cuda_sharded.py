"""The sharded mode on the card: a one-rank NCCL group (``core.mesh.
create_mesh()``), the exchange sending each rank's requests to itself.

Every test carries the ``cuda`` marker and skips without a card (the
``cuda`` fixture decides, at run time); the file imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_sharded.py

The sharded packed step of autoint (5 ids, attention dropout 0.2: K1,
K2 and K4 on the owners' side, K3, K5f, K5b, K8) and of staytime (K1, two
K2, K3, two K4, three K7, K9) against the local packed step on the card from the same
state, two steps: losses rtol 1e-5, weights and params atol 1e-5, moments
rtol 1e-3, atol 1e-8 (atomics and products summed in another order), t
and show exact; the staytime predict call (K7 gathering from the
exchanged rows) against the local one at rtol 1e-5, atol 2e-6.
"""

import pytest
import torch

from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
from recommendsystem_tpu_torch.train import make_predict_step, make_train_step
from recommendsystem_tpu_torch.train.state import create_train_state

pytestmark = pytest.mark.cuda
WANT = {"autoint": {"fold_mean": 2, "fold_rows": 2, "unfold_mean": 2, "unfold_rows": 2,
                    "field_attention": 2, "field_attention_bwd": 2, "sparse_adam_update": 2},
        "staytime": {"fold_mean": 2, "fold_rows": 4, "din_pool": 6, "unfold_mean": 2,
                     "unfold_rows": 4, "sparse_adagrad_update": 2}}


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import torch.distributed as dist

    from recommendsystem_tpu_torch.core.mesh import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    m = create_mesh()
    yield m
    dist.destroy_process_group()


def _bundle(model):
    if model == "autoint":
        return create_model("autoint", bucket_size=4096, device="cuda")
    return create_model("staytime", cfg=StaytimeConfig(bucket_size=512, seq_max_len=8),
                        device="cuda")


@pytest.mark.parametrize("model", ["autoint", "staytime"])
def test_sharded_step_on_one_rank_equals_the_local_step(mesh, model):
    assert mesh.size == 1 and mesh.device.type == "cuda"
    bundle = _bundle(model)
    batch, dense, labels, weight = synthetic_batch(bundle, 512, seed=4)
    sides = {}
    for mode in ("local", "sharded"):
        state = create_train_state(bundle, seed=1)
        step = make_train_step(bundle, mode=mode, mesh=mesh if mode == "sharded" else None)
        torch.cuda.synchronize()
        reset_launch_counts()
        infos = []
        for i in range(2):
            state, info = step(state, batch, labels, weight, dense, seed=i)
            infos.append(float(info["loss"]))
        torch.cuda.synchronize()
        sides[mode] = (state, infos, {k: v for k, v in launch_counts().items() if v})
    (ls, li, _), (ss, si, counts) = sides["local"], sides["sharded"]
    assert counts == WANT[model]
    torch.testing.assert_close(torch.tensor(si), torch.tensor(li), rtol=1e-5, atol=0)
    for k, p in ls.params.items():
        torch.testing.assert_close(ss.params[k], p, rtol=0, atol=1e-5, msg=k)
    for skey, t in ls.tables.items():
        torch.testing.assert_close(ss.tables[skey]["w"], t["w"], rtol=0, atol=1e-5)
        assert torch.equal(ss.tables[skey]["show"], t["show"])
        for name, v in t["opt"].items():
            if name == "t":
                assert torch.equal(ss.tables[skey]["opt"]["t"], v)
            else:
                torch.testing.assert_close(ss.tables[skey]["opt"][name], v, rtol=1e-3,
                                           atol=1e-8)


def test_sharded_staytime_predict_gathers_from_the_exchanged_rows(mesh):
    bundle = _bundle("staytime")
    state = create_train_state(bundle, seed=1)
    batch, dense, _, _ = synthetic_batch(bundle, 256, seed=6)
    want = make_predict_step(bundle)(state, batch, dense)
    reset_launch_counts()
    got = make_predict_step(bundle, mode="sharded", mesh=mesh)(state, batch, dense)
    torch.cuda.synchronize()
    assert {k: v for k, v in launch_counts().items() if v} == {"fold_mean": 1, "fold_rows": 1,
                                                                "din_pool": 3}
    for task, w in want.items():
        torch.testing.assert_close(got[task], w, rtol=1e-5, atol=2e-6)
