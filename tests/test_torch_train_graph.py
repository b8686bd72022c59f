"""The CUDA graph of the train step's stage 2 (``train/graph.py``), on the
CPU: the rule that chooses it, the dropout key the kernels read from
device memory, and the graph's bookkeeping, with a stand-in for the
capture.

The CPU has no CUDA graphs, so the bookkeeping runs under ``_CpuGraphs``:
its capture runs stage 2 once and keeps the outputs, and a "replay" runs
the captured function again on the graph's own buffers and copies the
results into those outputs, as a graph's replay rewrites them.  What a
replay reads is then what a card's graph reads: the static buffers that
the step feeds, the key written before it, the params' storage.  So steps
through it must equal the eager steps bit for bit, on the plain CPU
paths.  The card's own graphs are held to the eager steps in
``tests/test_torch_cuda_train_graph.py``."""

import dataclasses

import pytest
import torch
from torch.overrides import TorchFunctionMode

from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.kernels import field_attention as fa
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
from recommendsystem_tpu_torch.nn.interacting import InteractingLayer
from recommendsystem_tpu_torch.train import create_train_state, make_train_step
from recommendsystem_tpu_torch.train import graph as graph_mod
from recommendsystem_tpu_torch.train import losses
from test_torch_checkpoint import assert_states_equal

torch.set_num_threads(1)
B = 32
SEEDS = (7, 2 ** 31 + 5, 2 ** 32 - 1)


class _Replay:
    """A replay that runs the captured function again on its buffers."""

    def __init__(self, fn, args, outputs):
        self.fn, self.args, self.outputs = fn, args, outputs

    def replay(self):
        got, want = [], []
        graph_mod._flatten(graph_mod._detached(self.fn(*self.args)), got)
        graph_mod._flatten(self.outputs, want)
        with torch.no_grad():
            for w, g in zip(want, got):
                w.copy_(g)


class _CpuGraphs(graph_mod.TrainGraphs):
    """``TrainGraphs`` with the capture replaced by ``_Replay``;
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


class _Watch(TorchFunctionMode):
    """A pass-through function mode: under it the step runs eagerly."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _bundle(name):
    if name == "staytime":
        return create_model("staytime", cfg=StaytimeConfig(bucket_size=128, seq_max_len=4),
                            device="cpu")
    if name == "autoint_bf16":
        return create_model("autoint", bucket_size=64, compute_dtype=torch.bfloat16,
                            device="cpu")
    return create_model(name, bucket_size=256 if name == "rough_rank" else 64, device="cpu")


@pytest.fixture
def graphed(monkeypatch):
    """The rule taking the graph on the CPU, as it does on a card."""
    monkeypatch.setattr(graph_mod, "uses_graph", lambda device, mode, sparse_update: True)


def _steps(bundle, state, batches, seeds, step=None):
    step = step or make_train_step(bundle)
    infos = []
    for (batch, dense, labels, weight), seed in zip(batches, seeds):
        state, info = step(state, batch, labels, weight, dense, seed=seed)
        infos.append(info)
    return state, infos


@pytest.mark.parametrize("name", ["autoint", "staytime", "rough_rank", "multi_head",
                                  "autoint_bf16"])
def test_replayed_steps_equal_eager_steps(graphed, name):
    """Three steps through one captured stage 2 (autoint's attention
    dropout at 0.2 drawn from a new seed each step, staytime's sequences,
    rough_rank's dense inputs, multi_head's sample weights, the bf16
    policy) equal three eager steps from the same state, batches and
    seeds; each step's info stays its own after the next replay."""
    bundle = _bundle(name)
    bundle.train_graphs = _CpuGraphs()
    batches = [synthetic_batch(bundle, B, seed=60 + i) for i in range(3)]
    eager = create_train_state(bundle, seed=0)
    with _Watch():
        eager, want = _steps(bundle, eager, batches, SEEDS)
    assert bundle.train_graphs.records == 0
    state, got = _steps(bundle, create_train_state(bundle, seed=0), batches, SEEDS)
    assert (bundle.train_graphs.captures, bundle.train_graphs.replays) == (1, 3)
    assert not bundle.train_graphs.fallbacks
    assert_states_equal(state, eager)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(g[k], w[k]), k


def test_later_step_functions_replay_and_new_shapes_capture(graphed):
    """A second step function on the same bundle and state (a second
    ``fit``) captures nothing; a new batch shape captures one new graph;
    another state's param storage captures one in place of its shape's."""
    bundle = _bundle("autoint")
    bundle.train_graphs = _CpuGraphs()
    state = create_train_state(bundle, seed=0)
    batches = [synthetic_batch(bundle, B, seed=70 + i) for i in range(2)]
    state, _ = _steps(bundle, state, batches, SEEDS)
    state, _ = _steps(bundle, state, batches, SEEDS)
    assert (bundle.train_graphs.captures, bundle.train_graphs.replays) == (1, 4)
    state, _ = _steps(bundle, state, [synthetic_batch(bundle, B // 2, seed=72)], SEEDS)
    assert (bundle.train_graphs.captures, bundle.train_graphs.replays) == (2, 5)
    _steps(bundle, create_train_state(bundle, seed=1), batches[:1], SEEDS)
    assert (bundle.train_graphs.captures, bundle.train_graphs.replays) == (3, 6)
    assert len(bundle.train_graphs.graphs) == 2


def test_a_capture_that_raises_leaves_its_signature_eager(graphed):
    """A signature whose capture raises is recorded in ``fallbacks`` and
    tried once: its steps run eagerly and equal the eager steps."""
    bundle = _bundle("autoint")
    batches = [synthetic_batch(bundle, B, seed=80 + i) for i in range(3)]
    eager = create_train_state(bundle, seed=0)
    with _Watch():
        eager, want = _steps(bundle, eager, batches, SEEDS)
    bundle.train_graphs = _CpuGraphs(fail=True)
    state, got = _steps(bundle, create_train_state(bundle, seed=0), batches, SEEDS)
    graphs = bundle.train_graphs
    assert (graphs.records, graphs.captures, graphs.replays) == (1, 0, 0)
    assert [v.split(":")[0] for v in graphs.fallbacks.values()] == ["RuntimeError"]
    assert_states_equal(state, eager)
    assert all(torch.equal(g["loss"], w["loss"]) for g, w in zip(got, want))


def test_a_replaced_bundle_starts_without_graphs():
    bundle = _bundle("autoint")
    assert dataclasses.replace(bundle).train_graphs is not bundle.train_graphs


@pytest.mark.parametrize("device,mode,sparse_update,want", [
    ("cuda", "local", "packed", True),
    ("cpu", "local", "packed", False),
    ("cuda", "sharded", "packed", False),
    ("cuda", "local", "scatter", False),
    ("cuda", "local", "dense", False),
])
def test_the_rule_picks_the_graph_for_the_local_packed_step_on_a_card(
        device, mode, sparse_update, want):
    assert graph_mod.uses_graph(torch.device(device), mode, sparse_update) is want


def test_the_cpu_steps_never_capture():
    """On the CPU the step's rule is false: no graph, no capture."""
    bundle = _bundle("autoint")
    _steps(bundle, create_train_state(bundle, seed=0),
           [synthetic_batch(bundle, B, seed=90)], SEEDS)
    assert (bundle.train_graphs.captures, bundle.train_graphs.replays) == (0, 0)
    assert not bundle.train_graphs.graphs


@pytest.mark.parametrize("seed", [0, 2 ** 31, 2 ** 32 - 1, 2 ** 64 - 1])
def test_the_key_written_for_the_device_is_the_seeds_key(seed):
    """``dropout_key`` and ``write_key`` put ``_key(seed)`` in the one
    int64 word the kernels read, as k0 << 32 | k1 (little-endian: the low
    int32 word is k1)."""
    k0, k1 = fa._key(seed)
    made = fa.dropout_key(seed, "cpu")
    written = torch.zeros(1, dtype=torch.int64)
    fa.write_key(written, seed)
    for key in (made, written):
        assert fa._key(fa.key_seed(key)) == (k0, k1)
        lo, hi = (w % (1 << 32) for w in key.view(torch.int32).tolist())
        assert (hi, lo) == (k0, k1)


@pytest.mark.parametrize("seed", [0, 2 ** 31, 2 ** 32 - 1])
@pytest.mark.parametrize("i", [0, 1, 2])
def test_an_iterations_key_is_derived_on_the_device(seed, i):
    assert fa.key_seed(fa.iteration_key(fa.dropout_key(seed, "cpu"), i)) == (seed << 32) | i


def test_a_key_outside_its_range_or_form_raises():
    with pytest.raises(ValueError):
        fa.dropout_key(1 << 64, "cpu")
    with pytest.raises(ValueError):
        fa.field_attention(*(torch.ones(1, 4, 3, 2) for _ in range(3)),
                           seed=torch.zeros(2, dtype=torch.int64), rate=0.2)


def test_the_layer_draws_the_same_dropout_from_a_key_tensor():
    """The InteractingLayer given the key tensor of a step seed gives the
    outputs and gradients it gives with the int seed (two iterations, so
    the derived keys differ)."""
    torch.manual_seed(0)
    layer = InteractingLayer(8, layer_num=2, unit_num=8, head_num=2, use_dropout=True,
                             dropout_rate=0.2)
    x = torch.randn(16, 5, 8, requires_grad=True)
    for seed in SEEDS:
        by_int = layer(x, training=True, seed=seed)
        by_key = layer(x, training=True, seed=fa.dropout_key(seed, "cpu"))
        assert torch.equal(by_int, by_key)
        assert torch.equal(torch.autograd.grad(by_int.sum(), x)[0],
                           torch.autograd.grad(by_key.sum(), x)[0])


def test_the_clips_bounds_filled_on_the_device_give_new_tensors_results():
    """``_clip`` and the cut losses against filled bounds give the values
    and gradients of the ``new_tensor`` bounds they replace, ties
    included (``torch.maximum`` splits a tie's gradient)."""
    x = torch.tensor([1e-7, 0.5, 1.0, 3.0, -1.0], requires_grad=True)
    y = torch.tensor([[0.1, 2.0, 3.0, 1.5, 0.0]])

    def old_clip(t, lo, hi):
        return torch.minimum(torch.maximum(t, t.new_tensor(lo)), t.new_tensor(hi))

    pairs = [(losses._clip(x, 1e-7, 1.0), old_clip(x, 1e-7, 1.0)),
             (losses.mse_clip_loss(y, x[None]),
              (torch.minimum(y, x.new_tensor(2.0)) - x[None]).square().mean()),
             (losses.log_mse_loss(y * 1000, x[None]),
              (torch.minimum(torch.log((y * 1000) / 1000.0 + 1.0), x.new_tensor(5.3))
               - x[None]).square().mean())]
    for new, old in pairs:
        assert torch.equal(new, old)
        assert torch.equal(torch.autograd.grad(new.sum(), x)[0],
                           torch.autograd.grad(old.sum(), x)[0])
