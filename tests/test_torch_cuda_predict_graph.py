"""The CUDA graph of the local predict step (``train/graph.py``,
``PredictGraphs``) on the card.

Every test carries the ``cuda`` marker and skips without a card (the
``cuda`` fixture decides, at run time); the file imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_predict_graph.py

Replayed calls against eager calls of the same state and batches (the
eager side runs under a pass-through function mode, under which the step
does not replay), bit for bit: a replay runs the eager call's kernels on
the same inputs.  The launches a call the same on both sides; a call's
outputs survive the next replay; ``ScoringService`` captures once a bucket
and again after its state is reloaded; the sharded mode stays eager; every
factory of ``models/`` captures at a small size.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from chip_smoke import staytime_rows
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.models import create_model, dlrm_dcnv2
from recommendsystem_tpu_torch.models.base import MODEL_REGISTRY
from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
from recommendsystem_tpu_torch.serving import ScoringService
from recommendsystem_tpu_torch.train import create_train_state, make_predict_step
from recommendsystem_tpu_torch.utils import spans

pytestmark = pytest.mark.cuda
B = 256


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


def _calls(step, state, batches):
    """Each call's outputs (kept as returned) and its launches."""
    outs, launches = [], []
    for batch, dense, _, _ in batches:
        torch.cuda.synchronize()
        reset_launch_counts()
        outs.append(step(state, batch, dense))
        torch.cuda.synchronize()
        launches.append({k: v for k, v in launch_counts().items() if v})
    return outs, launches


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


@pytest.mark.parametrize("name", ["staytime", "autoint", "autoint_bf16", "dlrm_dcnv2"])
def test_replayed_calls_equal_eager_calls(cuda, name):
    """Four calls of one shape over four batches: the first eager, the
    second captured, then replays; each bit for bit the eager call on its
    batch, with the eager call's launches, and each still its own after
    the later replays."""
    bundle = _bundle(name)
    state = create_train_state(bundle, seed=1)
    batches = [synthetic_batch(bundle, B, seed=20 + i) for i in range(4)]
    step = make_predict_step(bundle)
    with _Eager():
        want, eager_launches = _calls(step, state, batches)
    graphs = bundle.predict_graphs
    assert (graphs.captures, graphs.seen) == (0, {})
    got, launches = _calls(step, state, batches)
    assert (graphs.captures, graphs.replays, graphs.fallbacks) == (1, 3, {})
    assert launches == eager_launches
    _assert_equal(got, want)


def test_replays_record_the_step_graph_span(cuda):
    bundle = _bundle("staytime")
    state = create_train_state(bundle, seed=0)
    batch, dense, _, _ = synthetic_batch(bundle, B, seed=50)
    step = make_predict_step(bundle)
    for _ in range(2):
        step(state, batch, dense)
    spans.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, batch, dense)
    names = [r[0] for r in spans.recorded()]
    assert "step.graph" in names
    assert "embedding.lookup" not in names and "model.forward" not in names


def _scores(svc, rows):
    return {k: np.asarray(v) for k, v in svc.score(rows).items()}


def test_the_service_captures_once_a_bucket_and_again_after_a_reload(cuda):
    """Two warm-ups capture one graph a bucket; a request replays its
    bucket's graph and scores as the eager call does; a reloaded state
    drops the old graphs, runs its first call a bucket eagerly and
    captures at the second, and scores as its own eager calls do."""
    bundle = _bundle("staytime")
    cfg = bundle.config
    rows = staytime_rows(np.random.default_rng(3), 200, cfg.slots, cfg.seq_slots)
    svc = ScoringService(bundle, create_train_state(bundle, seed=0), max_batch=256,
                         ids_per_feature=5)
    graphs, n = bundle.predict_graphs, len(svc.buckets)
    for states in range(2):
        with _Eager():
            want = _scores(svc, rows)
        svc.warmup()
        svc.warmup()
        assert (graphs.captures, len(graphs.graphs)) == (n * (states + 1), n)
        replays = graphs.replays
        got = _scores(svc, rows)
        assert graphs.replays == replays + 1
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        svc.state = create_train_state(bundle, seed=1)
    assert graphs.fallbacks == {}


def test_the_sharded_mode_stays_eager(cuda):
    import torch.distributed as dist

    from recommendsystem_tpu_torch.core.mesh import create_mesh

    mesh = create_mesh()
    try:
        bundle = _bundle("staytime")
        state = create_train_state(bundle, seed=1)
        batch, dense, _, _ = synthetic_batch(bundle, B, seed=4)
        step = make_predict_step(bundle, mode="sharded", mesh=mesh)
        for _ in range(3):
            step(state, batch, dense)
        torch.cuda.synchronize()
        graphs = bundle.predict_graphs
        assert (graphs.captures, graphs.replays, graphs.seen) == (0, 0, {})
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_every_factory_captures(cuda, name):
    bundle = _bundle(name)
    state = create_train_state(bundle, seed=0)
    batches = [synthetic_batch(bundle, B, seed=60 + i) for i in range(3)]
    step = make_predict_step(bundle)
    with _Eager():
        want, _ = _calls(step, state, batches)
    got, _ = _calls(step, state, batches)
    graphs = bundle.predict_graphs
    assert (graphs.captures, graphs.replays, graphs.fallbacks) == (1, 2, {})
    _assert_equal(got, want)
