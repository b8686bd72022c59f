"""Training harness: ``fit``, ``evaluate``, ``predict`` and ``dump_predict``.

Counterpart of ``recommendsystem_tpu/train/harness.py``, the platform
harness the reference's contracts imply (SURVEY §2.9: dataset -> model
factory -> compile -> fit/predict -> checkpoint -> dump_predict).

Datasets are iterables of tensors on the bundle's device, as
``data.dataset_reader`` and ``data.synthetic_batch`` make them: ``(batch,
dense_inputs, labels, sample_weight)``, and for ``predict`` and
``dump_predict`` optionally a fifth item, a dict of extras
(``example_id_key`` names the example ids in it).
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import TYPE_CHECKING, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from ..utils.spans import span
from . import metrics as M
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .state import TrainState, create_train_state, shard_state
from .step import (make_eval_step, make_predict_step, make_scan_train_step,
                   make_train_step)

if TYPE_CHECKING:
    from ..models.base import ModelBundle

log = logging.getLogger(__name__)


def seed_stream(seed: int) -> Iterator[int]:
    """The ints below 2**32 that ``fit(..., seed=seed)`` draws, in order: a
    ``torch.Generator`` seeded with ``seed`` (the port's counterpart of the
    JAX ``fit``'s ``PRNGKey`` splits).  ``fit`` takes one for the initial
    state when it makes one, then one for each train step (its dropout
    seed) and one for each eviction (the seed of the eviction's
    generator)."""
    gen = torch.Generator().manual_seed(seed)
    while True:
        yield int(torch.randint(0, 2 ** 32, (), generator=gen))


def fit(bundle: "ModelBundle", dataset: Iterable, steps: Optional[int] = None,
        state: Optional[TrainState] = None, seed: int = 0, mesh=None,
        mode: str = "local", log_every: int = 100,
        checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
        resume: bool = False, profile_dir: Optional[str] = None,
        profile_steps: tuple = (10, 20), history_path: Optional[str] = None,
        nan_guard: str = "warn", callbacks=(),
        evict_every: int = 0, scan_steps: int = 0, shardings=None) -> TrainState:
    """Train on ``dataset``'s (batch, dense_inputs, labels, sample_weight)
    items with the packed train step (``make_train_step``) for ``steps``
    steps or until it ends.  ``mode="sharded"`` with ``mesh`` trains each
    rank's rows of the data over its row shards of the tables (every rank
    calls ``fit`` with its own dataset and the same ``seed``); on a 2-D
    mesh ``shardings`` (the state's placements, as ``make_train_step``
    takes them) goes to the steps, to ``shard_state`` and to the
    checkpoint, which saves and restores the whole state (a collective:
    ``save_checkpoint(..., mesh=)``).

    ``state=None`` starts from ``create_train_state`` with the first seed
    of ``seed_stream(seed)`` (sharded: this rank's shards of it,
    ``shard_state``); each step takes the next as its dropout seed.
    ``resume=True`` restores the latest checkpoint under ``checkpoint_dir``
    before training (crash recovery); the seed stream starts afresh, as the
    JAX ``fit``'s key does.  ``checkpoint_every=N`` saves every N steps.
    ``profile_dir`` writes a ``torch.profiler`` Chrome trace
    (``trace.json``) over the steps ``profile_steps`` [start, stop), with
    the step's stages as spans (``utils/spans.py``: ``harness.step``,
    ``step.train``, ``embedding.plan``, ``embedding.gather``,
    ``model.forward``, ``model.backward``, ``step.dense_update``,
    ``embedding.update``).  ``history_path`` appends one JSON line per
    ``log_every`` steps (step, examples/s, the step's losses); the rate
    counts the examples since the previous log point over the time between
    the two log points' host reads of the loss, so it holds finished steps
    only, and the first log point has none (``null``).  ``nan_guard`` ('off'|'warn'|'raise')
    checks the loss at each log point: the loss is read on the host there
    and nowhere else, so the loop makes no other host sync.
    ``evict_every=N`` calls the engine's ``maybe_evict`` every N steps (the
    optimizer's ``feature_drop_show`` admission), with a generator on the
    bundle's device seeded from the stream.  ``scan_steps=K`` hands K items
    at a time to ``make_scan_train_step`` (the same steps one by one; short
    tails take single steps); log, checkpoint and evict cadences then fire
    at the first step boundary at or after their nominal step.
    ``callbacks`` are called as ``cb(step, state, info)`` after each
    dispatch.  Returns the state (its tensors are updated in place)."""
    with span("harness.fit"):
        if nan_guard not in ("off", "warn", "raise"):
            raise ValueError(f"nan_guard {nan_guard!r}: expected 'off', 'warn' or 'raise'")
        seeds = seed_stream(seed)
        on_mesh = {"mesh": mesh, "shardings": shardings} if mode == "sharded" else {}
        train_step = make_train_step(bundle, mode=mode, **on_mesh)
        scan_step = (make_scan_train_step(bundle, mode=mode, **on_mesh)
                     if scan_steps > 1 else None)
        if state is None:
            state = create_train_state(bundle, seed=next(seeds))
            if mode == "sharded":
                state = shard_state(bundle, state, mesh, shardings)
        if resume and checkpoint_dir and latest_step(checkpoint_dir) is not None:
            state = restore_checkpoint(checkpoint_dir, state, **on_mesh)
            log.info("resumed from %s at step %d", checkpoint_dir, state.step)

        it = iter(dataset)
        profiler = None
        read_at, seen_at_read = None, 0      # the last log point's host read
        seen = 0
        i = 0
        while steps is None or i < steps:
            if profile_dir and profiler is None and profile_steps[0] <= i < profile_steps[1]:
                profiler = _start_profiler(bundle.device)
            with span("harness.step"):
                try:
                    item = next(it)
                except StopIteration:
                    break
                chunk = [item]
                if scan_step is not None:
                    while len(chunk) < scan_steps and (steps is None or i + len(chunk) < steps):
                        try:
                            chunk.append(next(it))
                        except StopIteration:
                            break
                if len(chunk) > 1:
                    batches, dense, labels, weights = (list(x) for x in
                                                       zip(*(c[:4] for c in chunk)))
                    state, infos = scan_step(
                        state, batches, labels, None if weights[0] is None else weights,
                        None if dense[0] is None else dense,
                        [next(seeds) for _ in chunk])
                    info = {k: v[-1] for k, v in infos.items()}
                else:
                    batch, dense_inputs, labels, weight = item[:4]
                    state, info = train_step(state, batch, labels, weight, dense_inputs,
                                             seed=next(seeds))
                seen += sum(_batch_rows(c[0]) for c in chunk)
                i += len(chunk)
                stride = len(chunk)

                def crossed(every):
                    return every and (i // every) > ((i - stride) // every)

                if crossed(log_every):
                    read_at = _log_point(state, info, i, seen - seen_at_read, read_at,
                                         nan_guard, history_path)
                    seen_at_read = seen
                if crossed(evict_every):
                    gen = torch.Generator(device=bundle.device).manual_seed(next(seeds))
                    bundle.embedding.maybe_evict(state.tables, gen)
                if checkpoint_dir and crossed(checkpoint_every):
                    save_checkpoint(checkpoint_dir, state, **on_mesh)
                for cb in callbacks:
                    cb(i, state, info)
            if profiler is not None and i >= profile_steps[1]:
                _stop_profiler(profiler, profile_dir)
                profiler = None
        if profiler is not None:
            _stop_profiler(profiler, profile_dir)
    return state


def _batch_rows(batch) -> int:
    return next(iter(batch.values())).rows.shape[0]


def _log_point(state, info, i, examples, since, nan_guard, history_path) -> float:
    """The one host read of the loop: every scalar of ``info`` at once.
    Logs ``examples`` over the time since ``since``, the previous log
    point's read (None at the first: no rate); returns this read's time."""
    names = list(info)
    values = dict(zip(names, torch.stack([info[k].float() for k in names]).cpu().tolist()))
    now = time.perf_counter()
    rate = None if since is None else examples / (now - since)
    log.info("step %d loss=%.5f examples/s=%s", i, values["loss"],
             "n/a" if rate is None else f"{rate:.1f}")
    if nan_guard != "off" and not math.isfinite(values["loss"]):
        msg = f"non-finite loss {values['loss']} at step {i}"
        if nan_guard == "raise":
            raise FloatingPointError(msg)
        log.warning(msg)
    if history_path:
        rec = {"step": int(state.step),
               "examples_per_sec": None if rate is None else round(rate, 1), **values}
        with open(history_path, "a") as hf:
            hf.write(json.dumps(rec) + "\n")
    return now


def _start_profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: str) -> None:
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    profiler.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def evaluate(bundle: "ModelBundle", dataset: Iterable, state: TrainState,
             mode: str = "local") -> Dict[str, Dict[str, float]]:
    """{task: {metric name: value}} over the whole dataset.  The metric
    states stay on the bundle's device across batches; the values are
    copied to the host once, at the end (the loop makes no host sync).
    ``mode`` keeps the JAX signature, which passes the eval step no mesh:
    ``"sharded"`` raises there as it does here."""
    eval_step = make_eval_step(bundle, mode=mode)
    metric_states = M.init_metrics(bundle.metrics, bundle.device)
    for batch, dense_inputs, labels, weight in dataset:
        metric_states, _ = eval_step(state, batch, labels, weight, dense_inputs,
                                     metric_states)
    out = M.compute_metrics(bundle.metrics, metric_states)
    keys = [(task, name) for task, ms in out.items() for name in ms]
    if not keys:
        return {}
    values = torch.stack([out[t][n] for t, n in keys]).cpu().tolist()
    result: Dict[str, Dict[str, float]] = {t: {} for t in out}
    for (task, name), v in zip(keys, values):
        result[task][name] = v
    return result


def predict(bundle: "ModelBundle", dataset: Iterable, state: TrainState,
            mode: str = "local", example_id_key: Optional[str] = None):
    """Yields (example_ids, {task: numpy array}) per batch, the outputs of
    the predict step (``predict_view``) copied to the host: the
    ``example_id_slot`` dump contract (``rank/multi_head/multidnn.py:250``).
    The step's build and each call run in a ``harness.predict`` span, the
    copy in a ``harness.to_host`` one (``utils/spans.py``); the span closes
    before each yield, so the caller's code runs outside it."""
    predict_step = None
    it = iter(dataset)
    while True:
        with span("harness.predict"):        # closed before the yield
            if predict_step is None:
                predict_step = make_predict_step(bundle, mode=mode)
            try:
                item = next(it)
            except StopIteration:
                return
            batch, dense_inputs = item[0], item[1]
            extra = item[4] if len(item) > 4 else None
            outputs = predict_step(state, batch, dense_inputs)
            with span("harness.to_host"):
                outputs = {k: v.cpu().numpy() for k, v in outputs.items()}
                ids = None
                if extra is not None and example_id_key is not None:
                    ids = extra.get(example_id_key)
                    if isinstance(ids, torch.Tensor):
                        ids = ids.cpu().numpy()
        yield ids, outputs


def dump_predict(bundle: "ModelBundle", dataset: Iterable, state: TrainState,
                 path: str, mode: str = "local",
                 example_id_key: str = "example_id",
                 need_y: bool = False) -> int:
    """Write ``example_id \\t score...`` TSV rows, one score a task in
    sorted task order (the dump_predict util the reference imports from its
    absent platform, ``rank/multi_head/model.py:9``); returns the row count.
    A row without an example id takes its running index.

    ``need_y=True`` appends each task's label (its last column) after the
    scores: the reference's debug ``model_whit_input`` variant
    (``rank/multi_head/multidnn.py:252-258``)."""
    n = 0
    tasks = None
    dataset = list(dataset) if need_y else dataset
    label_iter = iter(dataset)
    with open(path, "w") as f:
        for ids, outputs in predict(bundle, dataset, state, mode=mode,
                                    example_id_key=example_id_key):
            if tasks is None:
                tasks = sorted(outputs.keys())
            labels = None
            if need_y:
                labels = {t: v.cpu().numpy() for t, v in next(label_iter)[2].items()}
            batch_n = len(next(iter(outputs.values())))
            for row in range(batch_n):
                eid = ids[row] if ids is not None else n
                cols = [str(eid)] + ["%.6g" % float(np.ravel(outputs[t][row])[0])
                                     for t in tasks]
                if labels is not None:
                    cols += ["%.6g" % float(np.ravel(labels[t][row])[-1])
                             for t in tasks if t in labels]
                f.write("\t".join(cols) + "\n")
                n += 1
    return n
