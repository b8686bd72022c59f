"""CUDA graphs of the local steps: the train step's stage 2 (the model
layer) and the whole predict step (the lookup and the forward).

Stage 2 of the packed train step (``train/step.py``) is the combine of the
folded activations, the tower's forward, the loss with its L1L2 penalty
and ``torch.autograd.grad`` with respect to the dense params and the
leaves: hundreds of small launches a step, each issued by the host.  The
predict step is the fused lookup (the grouped K1 and K2, the sequences'
``SequenceRows`` handles) and the tower's forward with its K7 gathering:
about a thousand launches a staytime call.  On a card each local step
captures its body once a signature as one CUDA graph and replays it, so
the host issues a few launches where it issued the whole body's.

- **Where the graphs live.** ``TrainGraphs`` and ``PredictGraphs``, kept
  with the bundle (``ModelBundle.train_graphs``, ``.predict_graphs``), so
  every step function built for the bundle (``fit`` and
  ``harness.predict`` build their own at each call) replays what an
  earlier one captured.  A graph's signature is what the code can
  observe: the structure, shapes and dtypes of its inputs, and the storage
  of the state it reads (the params, which dense Adam updates in place;
  for the predict step also each table's rows).  A model whose batch shape
  varies captures one graph a shape; a state with other storage (a new
  state, a restored or reloaded one, a table reallocated) captures anew in
  place of the graph of its shapes, so no graph replays the pointers of a
  state that is gone, and the graphs of such states do not pile up.
- **Feeding it.** The inputs are copied into the graph's static buffers by
  one ``torch._foreach_copy_`` a dtype.  Stage 2's inputs are the leaves
  (the folded activations), the masks, the labels, the sample weight and
  ``dense_inputs``; its dropout key is written into the graph's key buffer
  by one fill (``kernels.field_attention.write_key``); the batch's ids are
  not an input: stage 2 sees them as tensors on the ``meta`` device, so a
  stage 2 that read them could not be captured.  The predict step's inputs
  are the batch (ids and masks: the grouped kernels take their members'
  pointers by value, so the ids live in the graph's buffers) and
  ``dense_inputs``.
- **Its outputs.** Buffers of the graph, which the next replay overwrites:
  the train step reads the gradients on the same stream before it and
  copies the losses out; the predict step copies its outputs out (one
  ``_foreach_copy_`` a dtype) before it returns them.
- **Launch counts.** The capture's kernel launches are taken back and
  added on each replay (``kernels/_build.py``), so a replayed step counts
  what an eager one does.
- **When it is used.** ``uses_graph``: the local step on a CUDA device
  (for training, the packed one).  A step under a torch function or
  dispatch mode runs eagerly (the mode watches or changes the step's ops,
  which a replay does not run).  A signature whose capture raises runs
  eagerly from then on, and the reason is kept in ``fallbacks``.  The
  train step captures at the first step of a signature; a predict call
  replays from the second call of its signature with the same state on:
  its first call runs eagerly, so a shape that comes once (the last
  partial batch of a day, a GAUC tail) pays no capture, and a serving
  bucket or a bulk job's batch captures at its second call.  The predict
  graphs take a lock, so the threads of a server neither feed one graph at
  once nor launch beside a capture.

While a profiler is active each replay, with its feed, is a span:
``model.graph`` for stage 2, ``step.graph`` for a predict call, which
also holds the copy of its outputs (``utils/spans.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..kernels import _build
from ..kernels import field_attention as fa
from ..utils.spans import span

log = logging.getLogger(__name__)

# eager runs of a step's body on a side stream before its capture, as
# ``torch.cuda.make_graphed_callables`` makes them: lazy initialisation
# (cuBLAS workspaces, the autograd engine's device thread) stays out of
# the graph
WARMUP = 3


def uses_graph(device, mode: str, sparse_update: str = "packed") -> bool:
    """Whether a step of ``mode`` (and, training, ``sparse_update``) on
    ``device`` replays a CUDA graph: the local step on a card, for
    training the packed one.  The sharded step all-reduces inside stage 2
    and exchanges rows in its lookup (and the 2-D mesh stages its model
    axis through the host); the CPU has no graphs."""
    return (torch.device(device).type == "cuda" and mode == "local"
            and sparse_update == "packed")


def observed() -> bool:
    """A torch function or dispatch mode is active."""
    return (torch._C._len_torch_function_stack() > 0
            or torch._C._len_torch_dispatch_stack() > 0)


@dataclasses.dataclass
class _Graph:
    graph: Any                         # torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]         # static buffers the feed fills, in order
    outputs: Any                       # what the body returned in the capture
    launches: Dict[str, int]           # the kernel launches of one replay
    storage: tuple                     # the state's storage it reads
    device: torch.device
    key: Optional[torch.Tensor] = None  # the dropout key the kernels read (train)


def _flatten(tree, out: List[torch.Tensor]):
    """The tensors of a nest of dicts, lists, tuples and dataclasses of
    tensors (an ``IdBatch``) appended to ``out`` in order; returns the
    nest's hashable structure (None stays None)."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        return "*"
    if isinstance(tree, dict):
        return ("dict",) + tuple([(k, _flatten(v, out)) for k, v in tree.items()])
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple([_flatten(v, out) for v in tree])
    if tree is None:
        return None
    names = _fields(type(tree))
    if names:
        return (type(tree),) + tuple([(k, _flatten(getattr(tree, k), out)) for k in names])
    raise TypeError(f"graph input of type {type(tree).__name__}: expected tensors "
                    f"in dicts, lists, tuples and dataclasses")


@functools.lru_cache(maxsize=None)
def _fields(kind: type) -> tuple:
    """The field names of a dataclass type (empty for any other type)."""
    if not dataclasses.is_dataclass(kind):
        return ()
    return tuple(f.name for f in dataclasses.fields(kind))


def _unflatten(spec, it):
    """The nest ``_flatten`` described, its tensors taken from ``it``."""
    if spec == "*":
        return next(it)
    if spec is None:
        return None
    kind, items = spec[0], spec[1:]
    if kind == "dict":
        return {k: _unflatten(v, it) for k, v in items}
    if isinstance(kind, type):
        return kind(**{k: _unflatten(v, it) for k, v in items})
    seq = [_unflatten(v, it) for v in items]
    return tuple(seq) if kind == "tuple" else seq


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(t, device="meta")


def _detached(tree):
    """A nest's tensors detached: a graph's outputs keep no autograd graph
    of the capture alive."""
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree


def _by_dtype(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor]) -> None:
    """``dst[i].copy_(src[i])`` for every i, one ``_foreach_copy_`` a
    dtype (the fused copy takes one dtype a call)."""
    groups: Dict[torch.dtype, tuple] = {}
    for d, s in zip(dst, src):
        ds, ss = groups.setdefault(d.dtype, ([], []))
        ds.append(d)
        ss.append(s)
    with torch.no_grad():
        for ds, ss in groups.values():
            torch._foreach_copy_(ds, ss)


def _shapes(tensors: Sequence[torch.Tensor]) -> tuple:
    return tuple([(t.shape, t.dtype) for t in tensors])


def _storage(named: Dict[str, torch.Tensor]) -> tuple:
    """The storage a graph reads the state from: each tensor's pointer,
    shape and dtype."""
    return tuple([(k, t.data_ptr(), t.shape, t.dtype) for k, t in named.items()])


class _StepGraphs:
    """One bundle's graphs of one step, one for each signature of its
    inputs (module docstring): ``captures`` and ``replays`` count them;
    ``fallbacks`` maps each signature (with the state's storage) whose
    capture raised to the reason."""

    def __init__(self):
        self.graphs: Dict[tuple, _Graph] = {}
        self.fallbacks: Dict[tuple, str] = {}
        self.captures = 0
        self.replays = 0

    def _graph(self, sig, storage) -> Optional[_Graph]:
        """The graph of ``sig`` over ``storage``; a graph of ``sig`` over
        another state's storage is dropped, once its replays end."""
        g = self.graphs.get(sig)
        if g is not None and g.storage != storage:
            if g.device.type == "cuda":
                torch.cuda.synchronize(g.device)
            del self.graphs[sig]
            g = None
        return g

    def _capture(self, fn, args, inputs, sig, storage, device,
                 key=None) -> Optional[_Graph]:
        """``fn(*args)`` captured over the static ``inputs`` (which ``args``
        hold) and kept as ``sig``'s graph; None, with the reason in
        ``fallbacks``, where the capture raised."""
        before = _build.launch_counts()
        try:
            graph, outputs, launches = self._record(fn, args, device)
        except Exception as exc:       # noqa: BLE001 - any failure: this signature runs eagerly
            _build.set_launch_counts(before)
            why = self.fallbacks[(sig, storage)] = f"{type(exc).__name__}: {exc}"
            log.warning("%s runs eagerly for this signature: its capture raised %s",
                        type(self).__name__, why, exc_info=True)
            return None
        _build.set_launch_counts(before)
        g = _Graph(graph=graph, inputs=inputs, outputs=outputs, launches=launches,
                   storage=storage, device=device, key=key)
        self.graphs[sig] = g
        self.captures += 1
        return g

    def _replayed(self, g: _Graph) -> None:
        _build.add_launches(g.launches)
        self.replays += 1

    @staticmethod
    def _record(fn, args, device):
        """``WARMUP`` runs of ``fn(*args)`` on a side stream, then its
        capture: (the graph, its outputs, the kernel launches counted in the
        capture)."""
        stream = torch.cuda.current_stream(device)
        try:
            side = torch.cuda.Stream(device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    fn(*args)
            stream.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            mark = _build.launch_counts()
            # "thread_local": another thread's call that a capture forbids
            # (the loader thread's pin_memory) neither breaks this capture
            # nor fails in that thread
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = _detached(fn(*args))
            after = _build.launch_counts()
        except Exception:
            torch.cuda.set_stream(stream)      # a failed capture's end leaves its stream set
            torch.cuda.synchronize(device)
            raise
        return graph, outputs, {k: n - mark[k] for k, n in after.items() if n != mark[k]}


class TrainGraphs(_StepGraphs):
    """The stage-2 graphs of one bundle's local packed train step."""

    def run(self, fn: Callable, leaves: Sequence[torch.Tensor], inputs, rows,
            seed: int, params: Dict[str, torch.Tensor]):
        """``fn(leaves, inputs, rows, key)``'s result from this signature's
        graph, captured first if it has none; None where it runs eagerly
        (a capture that raised).  ``leaves`` are the tensors differentiated
        (the graph's copies need a gradient), ``inputs`` a nest of the other
        tensors stage 2 reads, ``rows`` the batch's ids ({column: tensor}),
        seen by ``fn`` on the meta device; ``key`` is the dropout key
        tensor, holding ``seed``."""
        flat: List[torch.Tensor] = []
        spec = _flatten(inputs, flat)
        sig = (spec, _shapes(list(leaves) + flat),
               tuple((k, tuple(t.shape), t.dtype) for k, t in rows.items()))
        storage = _storage(params)
        if (sig, storage) in self.fallbacks:
            return None
        g = self._graph(sig, storage)
        if g is None:
            device = leaves[0].device if leaves else flat[0].device
            static_leaves = [torch.empty_like(t).requires_grad_() for t in leaves]
            static = [torch.empty_like(t) for t in flat]
            _by_dtype(static_leaves + static, list(leaves) + flat)
            key = fa.dropout_key(seed, device)
            meta_rows = {k: _meta(t) for k, t in rows.items()}
            args = (static_leaves, _unflatten(spec, iter(static)), meta_rows, key)
            g = self._capture(fn, args, static_leaves + static, sig, storage, device, key)
            if g is None:
                return None
        with span("model.graph"):
            _by_dtype(g.inputs, list(leaves) + flat)
            fa.write_key(g.key, seed)
            g.graph.replay()
        self._replayed(g)
        return g.outputs


class PredictGraphs(_StepGraphs):
    """The graphs of one bundle's local predict step: ``seen`` holds, for
    each signature that has run eagerly, the storage of its last call."""

    def __init__(self):
        super().__init__()
        self.seen: Dict[tuple, tuple] = {}
        self._lock = threading.Lock()

    def run(self, fn: Callable, inputs: tuple, state: Dict[str, torch.Tensor]):
        """``fn(*inputs)``: eagerly at a signature's first call over
        ``state``'s storage (``state``: {name: every tensor of the state
        that ``fn`` reads}) and where its capture raised; from the second
        on, from the signature's graph, captured at that call, its outputs
        copied out of the graph's buffers."""
        with self._lock:
            flat: List[torch.Tensor] = []
            spec = _flatten(inputs, flat)
            sig = (spec, _shapes(flat))
            storage = _storage(state)
            if (sig, storage) in self.fallbacks:
                return fn(*inputs)
            g = self._graph(sig, storage)
            if g is None:
                if self.seen.get(sig) != storage:
                    self.seen[sig] = storage
                    return fn(*inputs)
                static = [torch.empty_like(t) for t in flat]
                _by_dtype(static, flat)
                g = self._capture(fn, tuple(_unflatten(spec, iter(static))), static, sig,
                                  storage, flat[0].device)
                if g is None:
                    return fn(*inputs)
            with span("step.graph"):
                _by_dtype(g.inputs, flat)
                g.graph.replay()
                held: List[torch.Tensor] = []
                out_spec = _flatten(g.outputs, held)
                copies = [torch.empty_like(t) for t in held]
                _by_dtype(copies, held)
            self._replayed(g)
            return _unflatten(out_spec, iter(copies))
