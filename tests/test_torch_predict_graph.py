"""The CUDA graph of the local predict step (``train/graph.py``,
``PredictGraphs``) on the CPU: the rule that chooses it and the graph's
bookkeeping, with a stand-in for the capture.

The CPU has no CUDA graphs, so the bookkeeping runs under ``_CpuGraphs``:
its capture runs the step's body once and keeps the outputs, and a
"replay" runs the body again on the graph's own buffers and copies the
results into those outputs, as a graph's replay rewrites them
(``test_torch_train_graph._Replay``).  What a replay reads is then what a
card's graph reads: the static buffers that the call feeds and the
state's storage.  So calls through it must equal the eager calls bit for
bit, and a call's outputs must survive the next replay.  The card's own
graphs are held to the eager calls in
``tests/test_torch_cuda_predict_graph.py``."""

import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.models import create_model, dlrm_dcnv2
from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
from recommendsystem_tpu_torch.train import create_train_state, make_predict_step
from recommendsystem_tpu_torch.train import graph as graph_mod
from test_torch_train_graph import _Replay, _Watch

torch.set_num_threads(1)
B = 32


class _CpuGraphs(graph_mod.PredictGraphs):
    """``PredictGraphs`` with the capture replaced by ``_Replay``;
    ``records`` counts the captures tried, ``fail`` makes them raise."""

    def __init__(self, fail=False):
        super().__init__()
        self.records, self.fail = 0, fail

    def _record(self, fn, args, device):
        self.records += 1
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        outputs = graph_mod._detached(fn(*args))
        return _Replay(fn, args, outputs), outputs, {}


class _Dispatch(TorchDispatchMode):
    """A pass-through dispatch mode: under it the call runs eagerly."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _bundle(name):
    if name == "staytime":
        return create_model("staytime", cfg=StaytimeConfig(bucket_size=128, seq_max_len=4),
                            device="cpu")
    if name == "autoint_bf16":
        return create_model("autoint", bucket_size=64, compute_dtype=torch.bfloat16,
                            device="cpu")
    if name == "dlrm_dcnv2":
        return create_model(name, rows=[min(r, 256) for r in dlrm_dcnv2.ROWS], device="cpu")
    return create_model(name, bucket_size=256 if name == "rough_rank" else 64, device="cpu")


@pytest.fixture
def graphed(monkeypatch):
    """The rule taking the graph for the local step on the CPU, as it does
    on a card."""
    rule = graph_mod.uses_graph
    monkeypatch.setattr(graph_mod, "uses_graph",
                        lambda device, mode, sparse_update="packed": rule("cuda", mode,
                                                                          sparse_update))


def _calls(step, state, batches):
    return [step(state, batch, dense) for batch, dense, _, _ in batches]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


@pytest.mark.parametrize("name", ["staytime", "autoint", "ctr", "multi_head", "finish",
                                  "rough_rank", "dlrm_dcnv2", "autoint_bf16"])
def test_replayed_calls_equal_eager_calls(graphed, name):
    """Four calls of one signature (the first eager, the second captured,
    then replays; staytime's sequences, dlrm_dcnv2's and rough_rank's dense
    inputs, the bf16 policy) equal four eager calls bit for bit, and every
    call's outputs stay its own after the later replays."""
    bundle = _bundle(name)
    bundle.predict_graphs = _CpuGraphs()
    state = create_train_state(bundle, seed=0)
    batches = [synthetic_batch(bundle, B, seed=60 + i) for i in range(4)]
    step = make_predict_step(bundle)
    with _Watch():
        want = _calls(step, state, batches)
    graphs = bundle.predict_graphs
    assert (graphs.records, graphs.seen) == (0, {})
    got = _calls(step, state, batches)
    assert (graphs.captures, graphs.replays, graphs.fallbacks) == (1, 3, {})
    _assert_equal(got, want)


def test_a_shape_seen_once_runs_eagerly_and_a_new_shape_captures(graphed):
    """A signature's first call runs eagerly; its second captures; a
    second step function on the bundle (a second ``harness.predict``)
    replays what the first captured; another batch shape captures its own
    graph at its second call."""
    bundle = _bundle("staytime")
    bundle.predict_graphs = _CpuGraphs()
    graphs = bundle.predict_graphs
    state = create_train_state(bundle, seed=0)
    batch, dense, _, _ = synthetic_batch(bundle, B, seed=70)
    small, small_dense, _, _ = synthetic_batch(bundle, B // 2, seed=71)
    make_predict_step(bundle)(state, batch, dense)
    assert (graphs.captures, graphs.replays, len(graphs.seen)) == (0, 0, 1)
    make_predict_step(bundle)(state, small, small_dense)
    assert (graphs.captures, graphs.replays, len(graphs.seen)) == (0, 0, 2)
    step = make_predict_step(bundle)
    step(state, batch, dense)
    step(state, batch, dense)
    assert (graphs.captures, graphs.replays) == (1, 2)
    step(state, small, small_dense)
    assert (graphs.captures, graphs.replays, len(graphs.graphs)) == (2, 3, 2)


@pytest.mark.parametrize("change", ["state", "params", "table"])
def test_new_storage_recaptures_and_drops_the_old_graph(graphed, change):
    """A new state, a param or a table reallocated (a restored checkpoint,
    a reloaded service, a table made anew): the signature's old graph is
    dropped at once, the call runs eagerly, the next one captures, and the
    replays read the new storage."""
    bundle = _bundle("staytime")
    bundle.predict_graphs = _CpuGraphs()
    graphs = bundle.predict_graphs
    state = create_train_state(bundle, seed=0)
    batch, dense, _, _ = synthetic_batch(bundle, B, seed=72)
    step = make_predict_step(bundle)
    for _ in range(2):
        step(state, batch, dense)
    assert (graphs.captures, len(graphs.graphs)) == (1, 1)
    if change == "state":
        state = create_train_state(bundle, seed=1)
    elif change == "params":
        k = next(iter(state.params))
        state.params[k] = state.params[k] * 2.0
    else:
        t = next(iter(state.tables.values()))
        t["w"] = t["w"] * 2.0
    with _Watch():
        want = step(state, batch, dense)
    first = step(state, batch, dense)
    assert (graphs.captures, len(graphs.graphs)) == (1, 0)
    got = [step(state, batch, dense) for _ in range(2)]
    assert (graphs.captures, graphs.replays, len(graphs.graphs)) == (2, 3, 1)
    _assert_equal([first] + got, [want] * 3)


def test_a_capture_that_raises_leaves_its_signature_eager(graphed):
    """A signature whose capture raises is recorded in ``fallbacks`` with
    its reason and tried once: its calls run eagerly and equal the eager
    calls."""
    bundle = _bundle("autoint")
    state = create_train_state(bundle, seed=0)
    batches = [synthetic_batch(bundle, B, seed=80)] * 4
    step = make_predict_step(bundle)
    with _Watch():
        want = _calls(step, state, batches)
    bundle.predict_graphs = _CpuGraphs(fail=True)
    step = make_predict_step(bundle)
    got = _calls(step, state, batches)
    graphs = bundle.predict_graphs
    assert (graphs.records, graphs.captures, graphs.replays) == (1, 0, 0)
    assert [v.split(":")[0] for v in graphs.fallbacks.values()] == ["RuntimeError"]
    _assert_equal(got, want)


@pytest.mark.parametrize("watch", [_Watch, _Dispatch])
def test_an_observed_call_runs_eagerly(graphed, watch):
    """Under a torch function or dispatch mode the call runs eagerly, and
    the graphs neither see nor capture it."""
    bundle = _bundle("autoint")
    bundle.predict_graphs = _CpuGraphs()
    state = create_train_state(bundle, seed=0)
    batch, dense, _, _ = synthetic_batch(bundle, B, seed=90)
    step = make_predict_step(bundle)
    with watch():
        for _ in range(3):
            step(state, batch, dense)
    graphs = bundle.predict_graphs
    assert (graphs.records, graphs.seen, graphs.replays) == (0, {}, 0)


def test_the_sharded_step_runs_eagerly(graphed):
    """The sharded step (here on a one-rank gloo group) never reaches the
    graphs, whose rule takes the local step alone."""
    from recommendsystem_tpu_torch.core.mesh import create_mesh

    mesh = create_mesh("cpu")
    try:
        bundle = _bundle("autoint")
        bundle.predict_graphs = _CpuGraphs()
        state = create_train_state(bundle, seed=0)
        batch, dense, _, _ = synthetic_batch(bundle, B, seed=91)
        step = make_predict_step(bundle, mode="sharded", mesh=mesh)
        for _ in range(3):
            step(state, batch, dense)
    finally:
        dist.destroy_process_group()
    graphs = bundle.predict_graphs
    assert (graphs.records, graphs.seen, graphs.replays) == (0, {}, 0)


def test_the_cpu_calls_never_reach_the_graphs():
    """On the CPU the rule is false: the graphs see no call."""
    bundle = _bundle("autoint")
    state = create_train_state(bundle, seed=0)
    batch, dense, _, _ = synthetic_batch(bundle, B, seed=92)
    step = make_predict_step(bundle)
    for _ in range(3):
        step(state, batch, dense)
    graphs = bundle.predict_graphs
    assert (graphs.captures, graphs.replays, graphs.seen) == (0, 0, {})


@pytest.mark.parametrize("device,mode,want", [
    ("cuda", "local", True), ("cpu", "local", False), ("cuda", "sharded", False)])
def test_the_rule_picks_the_graph_for_the_local_predict_step_on_a_card(device, mode, want):
    assert graph_mod.uses_graph(torch.device(device), mode) is want


def test_an_id_batch_flattens_and_comes_back():
    """The batch's ``IdBatch`` columns are dataclasses: the feed flattens
    their ids and masks and the capture rebuilds them over its buffers."""
    from recommendsystem_tpu_torch.embedding.engine import IdBatch

    batch = {"a": IdBatch(rows=torch.arange(6).view(2, 3), mask=torch.ones(2, 3)),
             "b": IdBatch(rows=torch.zeros(2, 1, dtype=torch.int32), mask=torch.ones(2, 1))}
    flat = []
    spec = graph_mod._flatten((batch, None), flat)
    assert len(flat) == 4
    back, dense = graph_mod._unflatten(spec, iter(flat))
    assert dense is None and back.keys() == batch.keys()
    for k, v in batch.items():
        assert isinstance(back[k], IdBatch)
        assert back[k].rows is v.rows and back[k].mask is v.mask


def test_threads_calling_at_once_each_get_their_own_outputs(graphed):
    """Eight threads (more than this test's one intra-op thread and the
    host's cores it is given) call one step of one signature at once, each
    over its own batch, with a short switch interval: each call's outputs
    are its batch's eager ones, so no thread's feed reached another's
    replay or copy-out."""
    import sys
    import threading

    bundle = _bundle("autoint")
    bundle.predict_graphs = _CpuGraphs()
    state = create_train_state(bundle, seed=0)
    batches = [synthetic_batch(bundle, B, seed=100 + i) for i in range(8)]
    step = make_predict_step(bundle)
    with _Watch():
        want = _calls(step, state, batches)
    got, errors = [None] * len(batches), []

    def work(i):
        try:
            batch, dense, _, _ = batches[i]
            got[i] = [step(state, batch, dense) for _ in range(3)]
        except Exception as exc:       # noqa: BLE001 - reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(batches))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert bundle.predict_graphs.captures == 1
    for calls, w in zip(got, want):
        _assert_equal(calls, [w] * len(calls))
