"""CUDA graphs of the local train step's stage 2: the model layer.

Stage 2 of the packed train step (``train/step.py``) is the combine of the
folded activations, the tower's forward, the loss with its L1L2 penalty
and ``torch.autograd.grad`` with respect to the dense params and the
leaves: hundreds of small launches a step, each issued by the host.  On a
card the local step captures it once as one CUDA graph and replays it on
every later step with the same signature, so the host issues a few
launches where it issued the tower's.

- **Where the graphs live.** ``TrainGraphs``, kept with the bundle
  (``ModelBundle.train_graphs``), so every step function built for the
  bundle (``fit`` builds its own at each call) replays what an earlier one
  captured.  A graph's signature is what the code can observe: the
  structure, shapes and dtypes of its inputs (the leaves, the masks the
  combine reads, the labels, the sample weight, ``dense_inputs``), the
  shapes of the batch's ids, and the storage of the params, which dense
  Adam updates in place.  A model whose batch shape varies captures one
  graph a shape; a state with other param storage (a new state, a
  restored one) captures anew in place of the graph of its shapes, so the
  graphs of states that are gone do not pile up.
- **Feeding it.** The inputs are copied into the graph's static buffers by
  one ``torch._foreach_copy_`` a dtype, and the step's dropout key is
  written into the graph's key buffer by one fill
  (``kernels.field_attention.write_key``); then the graph replays.  The
  batch's ids are not an input: the graph sees them as tensors on the
  ``meta`` device, so a stage 2 that read them could not be captured.
- **Its outputs.** Buffers of the graph, which the next replay overwrites:
  the step reads the gradients on the same stream before it, and copies
  the losses out (``replay``'s caller).
- **Launch counts.** The capture's kernel launches are taken back and
  added on each replay (``kernels/_build.py``), so a replayed step counts
  what an eager one does.
- **When it is used.** ``uses_graph``: the local packed step on a CUDA
  device.  A step under a torch function or dispatch mode runs eagerly
  (the mode watches or changes the tower's ops, which a replay does not
  run).  A signature whose capture raises runs eagerly from then on, and
  the reason is kept in ``fallbacks``.

While a profiler is active each replay, with its feed, is the span
``model.graph`` (``utils/spans.py``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..kernels import _build
from ..kernels import field_attention as fa
from ..utils.spans import span

log = logging.getLogger(__name__)

# eager runs of stage 2 on a side stream before its capture, as
# ``torch.cuda.make_graphed_callables`` makes them: lazy initialisation
# (cuBLAS workspaces, the autograd engine's device thread) stays out of
# the graph
WARMUP = 3


def uses_graph(device, mode: str, sparse_update: str) -> bool:
    """Whether a train step of ``mode`` and ``sparse_update`` on
    ``device`` replays its stage 2 as a CUDA graph: the local packed step
    on a card.  The sharded step all-reduces its loss and gradients inside
    stage 2 (and the 2-D mesh stages its model axis through the host); the
    CPU has no graphs."""
    return (torch.device(device).type == "cuda" and mode == "local"
            and sparse_update == "packed")


def observed() -> bool:
    """A torch function or dispatch mode is active."""
    return (torch._C._len_torch_function_stack() > 0
            or torch._C._len_torch_dispatch_stack() > 0)


@dataclasses.dataclass
class _Graph:
    graph: Any                         # torch.cuda.CUDAGraph
    leaves: List[torch.Tensor]         # static leaves (they need a gradient)
    inputs: List[torch.Tensor]         # static buffers of the other inputs
    key: torch.Tensor                  # the dropout key the kernels read
    outputs: Any                       # what stage 2 returned in the capture
    launches: Dict[str, int]           # the kernel launches of one replay
    params: tuple                      # the params' storage it reads


def _flatten(tree, out: List[torch.Tensor]):
    """The tensors of a nest of dicts, lists and tuples appended to
    ``out`` in order; returns the nest's hashable structure (None stays
    None)."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        return "*"
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _flatten(v, out)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_flatten(v, out) for v in tree)
    if tree is None:
        return None
    raise TypeError(f"stage 2 input of type {type(tree).__name__}: expected tensors "
                    f"in dicts, lists and tuples")


def _unflatten(spec, it):
    """The nest ``_flatten`` described, its tensors taken from ``it``."""
    if spec == "*":
        return next(it)
    if spec is None:
        return None
    kind, items = spec[0], spec[1:]
    if kind == "dict":
        return {k: _unflatten(v, it) for k, v in items}
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


class TrainGraphs:
    """The stage-2 graphs of one bundle, one for each signature of the
    inputs (module docstring): ``captures`` and ``replays`` count them;
    ``fallbacks`` maps each signature (with the params') whose capture
    raised to the reason."""

    def __init__(self):
        self.graphs: Dict[tuple, _Graph] = {}
        self.fallbacks: Dict[tuple, str] = {}
        self.captures = 0
        self.replays = 0

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
        sig = (spec,
               tuple((tuple(t.shape), t.dtype) for t in list(leaves) + flat),
               tuple((k, tuple(t.shape), t.dtype) for k, t in rows.items()))
        storage = tuple((k, p.data_ptr(), tuple(p.shape), p.dtype) for k, p in params.items())
        if (sig, storage) in self.fallbacks:
            return None
        g = self.graphs.get(sig)
        if g is None or g.params != storage:
            if g is not None:                  # another state's: its replays end first
                if g.key.is_cuda:
                    torch.cuda.synchronize(g.key.device)
                del self.graphs[sig], g
            g = self._capture(fn, leaves, flat, spec, rows, seed, sig, storage)
            if g is None:
                return None
        with span("model.graph"):
            _by_dtype(g.leaves + g.inputs, list(leaves) + flat)
            fa.write_key(g.key, seed)
            g.graph.replay()
        _build.add_launches(g.launches)
        self.replays += 1
        return g.outputs

    def _capture(self, fn, leaves, flat, spec, rows, seed, sig, storage) -> Optional[_Graph]:
        device = leaves[0].device if leaves else flat[0].device
        static_leaves = [torch.empty_like(t).requires_grad_() for t in leaves]
        static = [torch.empty_like(t) for t in flat]
        _by_dtype(static_leaves + static, list(leaves) + flat)
        key = fa.dropout_key(seed, device)
        meta_rows = {k: _meta(t) for k, t in rows.items()}
        args = (static_leaves, _unflatten(spec, iter(static)), meta_rows, key)
        before = _build.launch_counts()
        try:
            graph, outputs, launches = self._record(fn, args, device)
        except Exception as exc:       # noqa: BLE001 - any failure: this signature runs eagerly
            _build.set_launch_counts(before)
            why = self.fallbacks[(sig, storage)] = f"{type(exc).__name__}: {exc}"
            log.warning("stage 2 runs eagerly for this signature: its capture raised %s",
                        why, exc_info=True)
            return None
        _build.set_launch_counts(before)
        g = _Graph(graph=graph, leaves=static_leaves, inputs=static, key=key,
                   outputs=outputs, launches=launches, params=storage)
        self.graphs[sig] = g
        self.captures += 1
        return g

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
