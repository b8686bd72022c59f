"""Faults planted underneath the program's timed path, for the readings
that bound ``correct`` from above (``calibrate.py``) and for the tests that
a broken path comes out not correct (``tests/test_bench_runs.py``,
``tests/test_bench_sharded.py``).

- ``half_batch`` (train): the step trains on the first half of each
  batch's rows (ids, labels, weights and dense features) alone, its loss
  the mean over them;
- ``state_unchanged`` (train): the step computes its loss and then leaves
  every tensor of the state as it found it;
- ``dense_unchanged`` (train): the dense optimizer's step is lost: the
  dense parameters stay as they were, while the tables and every
  optimizer state move;
- ``backward_halved`` (train): the gradient into the configuration's
  ``backward_fault`` layers (every top-level module of that group, as
  ``compare.group`` names it: the MLP of autoint, the DIN pools of
  staytime) is half what it should be; their forward is unchanged;
- ``answer_altered`` (predict): each call's first row of its first task
  is scaled by 1.01 where the call produces it;
- ``dense_zeroed`` (train and predict, a configuration with dense
  features): the step or call gets zeros in place of the dense features;
- ``exchange_dropped`` (a sharded train step): the all-to-alls of the
  exchange between cards send nothing (every rank receives zeros).

Each is planted by replacing the program's own step factory (or
collective) that ``train/harness.py`` calls, for the duration of a
``with planted(kind)`` block.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

FAULTS = {"train": ("half_batch", "state_unchanged", "dense_unchanged", "backward_halved"),
          "predict": ("answer_altered",)}
SHARDED_FAULTS = ("exchange_dropped",)
DENSE_FAULTS = ("dense_zeroed",)


def faults_of(cell, sharded: bool) -> tuple:
    """Every fault the cell can have: its entry's, the exchange's on more
    than one rank, the dense features' where its configuration has some."""
    return (FAULTS[cell.traffic["entry"]] + (SHARDED_FAULTS if sharded else ())
            + (DENSE_FAULTS if hasattr(cell.model, "dense") else ()))


def _half(batch, labels, weight, dense):
    n = next(iter(batch.values())).rows.shape[0] // 2
    cut = {k: dataclasses.replace(v, rows=v.rows[:n], mask=v.mask[:n]) for k, v in batch.items()}
    return (cut, {k: v[:n] for k, v in labels.items()}, None if weight is None else weight[:n],
            None if dense is None else {k: v[:n] for k, v in dense.items()})


def _zeros(dense):
    return None if dense is None else {k: torch.zeros_like(v) for k, v in dense.items()}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _halve_backward(module, target: str) -> list:
    """Forward hooks that halve the gradient into every top-level module
    of ``module`` in group ``target``; the hooks' handles."""
    from harness.compare import group

    def hook(_mod, _inputs, out):
        return 0.5 * out + 0.5 * out.detach()

    return [child.register_forward_hook(hook) for name, child in module.named_children()
            if group(name) == target]


@contextlib.contextmanager
def planted(kind: str, cfg: dict = None):
    """Plant ``kind`` ("sound" plants nothing, nor does "control", which
    replaces the program by the reference elsewhere); ``cfg``, the cell's
    configuration, names the layers of ``backward_halved``."""
    if kind in ("sound", "control"):
        yield
        return
    from recommendsystem_tpu_torch.embedding import engine
    from recommendsystem_tpu_torch.train import harness

    saved = (harness.make_train_step, harness.make_predict_step, engine._a2a)
    make_train, make_predict = saved[0], saved[1]
    hooks: list = []

    if kind == "half_batch":
        def make(bundle, **kw):
            step = make_train(bundle, **kw)

            def broken(state, batch, labels, weight=None, dense=None, seed=0):
                return step(state, *_half(batch, labels, weight, dense), seed=seed)
            return broken
        harness.make_train_step = make
    elif kind == "state_unchanged":
        def make(bundle, **kw):
            step = make_train(bundle, **kw)

            def broken(state, batch, labels, weight=None, dense=None, seed=0):
                kept = [(t, t.clone()) for t in _tensors(
                    {"p": state.params, "o": state.opt_state, "t": state.tables})]
                new, info = step(state, batch, labels, weight, dense, seed=seed)
                for t, old in kept:
                    t.copy_(old)
                opt = dict(new.opt_state, count=state.opt_state["count"])
                return dataclasses.replace(new, opt_state=opt, step=state.step), info
            return broken
        harness.make_train_step = make
    elif kind == "dense_unchanged":
        def make(bundle, **kw):
            step = make_train(bundle, **kw)

            def broken(state, batch, labels, weight=None, dense=None, seed=0):
                kept = {k: v.clone() for k, v in state.params.items()}
                new, info = step(state, batch, labels, weight, dense, seed=seed)
                for k, v in new.params.items():
                    v.copy_(kept[k])
                return new, info
            return broken
        harness.make_train_step = make
    elif kind == "backward_halved":
        def make(bundle, **kw):
            hooks.extend(_halve_backward(bundle.module, cfg["backward_fault"]))
            if not hooks:
                raise ValueError(f"no layer of group {cfg['backward_fault']!r}")
            return make_train(bundle, **kw)
        harness.make_train_step = make
    elif kind == "answer_altered":
        def make(bundle, **kw):
            step = make_predict(bundle, **kw)

            def broken(state, batch, dense=None):
                out = dict(step(state, batch, dense))
                task = next(iter(out))
                out[task] = out[task].clone()
                out[task][0] *= 1.01
                return out
            return broken
        harness.make_predict_step = make
    elif kind == "dense_zeroed":
        def make_t(bundle, **kw):
            step = make_train(bundle, **kw)

            def broken(state, batch, labels, weight=None, dense=None, seed=0):
                return step(state, batch, labels, weight, _zeros(dense), seed=seed)
            return broken

        def make_p(bundle, **kw):
            step = make_predict(bundle, **kw)

            def broken(state, batch, dense=None):
                return step(state, batch, _zeros(dense))
            return broken
        harness.make_train_step, harness.make_predict_step = make_t, make_p
    elif kind == "exchange_dropped":
        def dropped(x, mesh):
            return torch.zeros_like(x)
        engine._a2a = dropped
    else:
        raise ValueError(f"unknown fault {kind!r}")
    try:
        yield
    finally:
        harness.make_train_step, harness.make_predict_step, engine._a2a = saved
        for h in hooks:
            h.remove()
