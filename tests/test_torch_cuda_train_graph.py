"""The CUDA graph of the local train step's stage 2 (``train/graph.py``) on
the card.

Every test carries the ``cuda`` marker and skips without a card (the
``cuda`` fixture decides, at run time); the file imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_train_graph.py

K graphed steps against K eager steps from the same state, batches and
seeds (the eager side runs under a pass-through function mode, under
which the step does not replay), held at ``chip_smoke.py``'s card-vs-CPU
tolerances: losses ``TRAIN_LOSS_RTOL``, params and table rows
``TRAIN_W_ATOL``, Adam's and AdaGrad's moments ``TRAIN_MOMENT_TOL``, t
and show exact; the launches a step the same on both sides.  Autoint with
its attention dropout at 0.2 and a new seed each step (K5f and K5b read
the key from the graph's key buffer), a small staytime, autoint under the
bf16 policy; a second ``fit`` captures nothing, a new batch shape one
graph, the sharded mode none; a thread pinning host memory (the data
loader's) during a capture breaks neither; every factory of ``models/``
captures at a small size.
"""

import pytest
import torch
from torch.overrides import TorchFunctionMode

from chip_smoke import TRAIN_LOSS_RTOL, TRAIN_MOMENT_TOL, TRAIN_W_ATOL
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.models import create_model, dlrm_dcnv2
from recommendsystem_tpu_torch.models.base import MODEL_REGISTRY
from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
from recommendsystem_tpu_torch.train import create_train_state, fit, make_train_step
from recommendsystem_tpu_torch.utils import spans

pytestmark = pytest.mark.cuda
B = 512
SEEDS = (11, 2 ** 31 + 7, 2 ** 32 - 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()
    return torch.device("cuda")


class _Eager(TorchFunctionMode):
    """A pass-through function mode: under it the step runs eagerly."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _bundle(name):
    if name == "staytime":
        return create_model("staytime", cfg=StaytimeConfig(bucket_size=512, seq_max_len=8),
                            device="cuda")
    if name == "autoint_bf16":
        return create_model("autoint", bucket_size=4096, compute_dtype=torch.bfloat16,
                            device="cuda")
    if name == "dlrm_dcnv2":
        return create_model(name, rows=[min(r, 4096) for r in dlrm_dcnv2.ROWS], device="cuda")
    return create_model(name, bucket_size=4096, device="cuda")


def _run(bundle, state, batches, seeds):
    """The steps and, a step, their losses (floats) and launches."""
    step = make_train_step(bundle)
    torch.cuda.synchronize()
    reset_launch_counts()
    losses = []
    for (batch, dense, labels, weight), seed in zip(batches, seeds):
        state, info = step(state, batch, labels, weight, dense, seed=seed)
        losses.append(info)
    torch.cuda.synchronize()
    launches = {k: v / len(batches) for k, v in launch_counts().items() if v}
    return state, [{k: float(v) for k, v in i.items()} for i in losses], launches


def _close_states(got, want):
    for k, p in want.params.items():
        torch.testing.assert_close(got.params[k], p, rtol=0, atol=TRAIN_W_ATOL, msg=k)
    assert got.opt_state["count"] == want.opt_state["count"]
    for m in ("mu", "nu"):
        for k, p in want.opt_state[m].items():
            torch.testing.assert_close(got.opt_state[m][k], p, **TRAIN_MOMENT_TOL, msg=k)
    for skey, t in want.tables.items():
        g = got.tables[skey]
        torch.testing.assert_close(g["w"].float(), t["w"].float(), rtol=0, atol=TRAIN_W_ATOL)
        assert torch.equal(g["show"], t["show"]), skey
        for name, x in t["opt"].items():
            if name == "t":
                assert torch.equal(g["opt"][name], x), (skey, name)
            else:
                torch.testing.assert_close(g["opt"][name].float(), x.float(),
                                           **TRAIN_MOMENT_TOL, msg=f"{skey} {name}")


@pytest.mark.parametrize("name", ["autoint", "staytime", "autoint_bf16"])
def test_graphed_steps_equal_eager_steps(cuda, name):
    bundle = _bundle(name)
    batches = [synthetic_batch(bundle, B, seed=20 + i) for i in range(len(SEEDS))]
    with _Eager():
        eager, want, eager_launches = _run(bundle, create_train_state(bundle, seed=1),
                                           batches, SEEDS)
    assert bundle.train_graphs.captures == 0
    state, got, launches = _run(bundle, create_train_state(bundle, seed=1), batches, SEEDS)
    graphs = bundle.train_graphs
    assert (graphs.captures, graphs.replays, graphs.fallbacks) == (1, len(SEEDS), {})
    assert launches == eager_launches
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=TRAIN_LOSS_RTOL, abs=0), k
    _close_states(state, eager)


def test_a_second_fit_captures_nothing_and_replays(cuda):
    bundle = _bundle("autoint")
    data = [synthetic_batch(bundle, B, seed=30 + i) for i in range(3)]
    state = fit(bundle, data, steps=3, seed=5, log_every=0)
    graphs = bundle.train_graphs
    assert (graphs.captures, graphs.replays) == (1, 3)
    fit(bundle, data, steps=3, state=state, seed=6, log_every=0)
    assert (graphs.captures, graphs.replays) == (1, 6)


def test_a_new_batch_shape_captures_one_graph(cuda):
    bundle = _bundle("staytime")
    state = create_train_state(bundle, seed=0)
    shapes = [B, B // 2, B, B // 2]
    batches = [synthetic_batch(bundle, b, seed=40 + i) for i, b in enumerate(shapes)]
    _run(bundle, state, batches, range(len(shapes)))
    assert (bundle.train_graphs.captures, bundle.train_graphs.replays) == (2, 4)


def test_replays_record_the_model_graph_span(cuda):
    bundle = _bundle("autoint")
    state = create_train_state(bundle, seed=0)
    batch, dense, labels, weight = synthetic_batch(bundle, B, seed=50)
    step = make_train_step(bundle)
    state, _ = step(state, batch, labels, weight, dense, seed=1)
    spans.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, batch, labels, weight, dense, seed=2)
    names = [r[0] for r in spans.recorded()]
    assert "model.graph" in names and "step.train" in names
    assert "model.forward" not in names and "model.backward" not in names


def test_a_capture_beside_a_pinning_thread(cuda):
    """A thread that pins host memory while the step captures (the data
    loader's) neither breaks the capture nor fails."""
    import threading

    bundle = _bundle("autoint")
    state = create_train_state(bundle, seed=0)
    batch, dense, labels, weight = synthetic_batch(bundle, B, seed=55)
    stop, errors = threading.Event(), []

    def pin():
        try:
            while not stop.is_set():
                torch.empty(1 << 16).pin_memory()
        except Exception as exc:       # noqa: BLE001 - reported below
            errors.append(exc)

    t = threading.Thread(target=pin)
    t.start()
    try:
        step = make_train_step(bundle)
        for i in range(2):
            state, _ = step(state, batch, labels, weight, dense, seed=i)
        torch.cuda.synchronize()
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and errors == []
    graphs = bundle.train_graphs
    assert (graphs.captures, graphs.replays, graphs.fallbacks) == (1, 2, {})


def test_the_sharded_mode_stays_eager(cuda):
    import torch.distributed as dist

    from recommendsystem_tpu_torch.core.mesh import create_mesh

    mesh = create_mesh()
    try:
        bundle = _bundle("autoint")
        state = create_train_state(bundle, seed=1)
        batch, dense, labels, weight = synthetic_batch(bundle, B, seed=4)
        step = make_train_step(bundle, mode="sharded", mesh=mesh)
        for i in range(2):
            state, info = step(state, batch, labels, weight, dense, seed=i)
        torch.cuda.synchronize()
        assert (bundle.train_graphs.captures, bundle.train_graphs.replays) == (0, 0)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_every_factory_captures(cuda, name):
    bundle = _bundle(name)
    batches = [synthetic_batch(bundle, 256, seed=60 + i) for i in range(2)]
    state, infos, _ = _run(bundle, create_train_state(bundle, seed=0), batches, (3, 4))
    graphs = bundle.train_graphs
    assert (graphs.captures, graphs.replays, graphs.fallbacks) == (1, 2, {})
    assert all(torch.isfinite(torch.tensor(i["loss"])) for i in infos)
