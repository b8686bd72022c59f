"""Eval and prediction harness: ``evaluate``, ``predict`` and ``dump_predict``.

Counterpart of ``recommendsystem_tpu/train/harness.py:154-214``.  ``fit``
is not ported yet: it saves and restores checkpoints, and comes with the
port's checkpoint module; until then a caller drives
``train.step.make_train_step`` itself.

Datasets are iterables of tensors on the bundle's device, as
``data.synthetic_batch`` makes them: ``(batch, dense_inputs, labels,
sample_weight)``, and for ``predict`` and ``dump_predict`` optionally a
fifth item, a dict of extras (``example_id_key`` names the example ids in
it).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Iterable, Optional

import numpy as np
import torch

from . import metrics as M
from .state import TrainState
from .step import make_eval_step, make_predict_step

if TYPE_CHECKING:
    from ..models.base import ModelBundle


def evaluate(bundle: "ModelBundle", dataset: Iterable, state: TrainState,
             mode: str = "local") -> Dict[str, Dict[str, float]]:
    """{task: {metric name: value}} over the whole dataset.  The metric
    states stay on the bundle's device across batches; the values are
    copied to the host once, at the end (the loop makes no host sync)."""
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
    ``example_id_slot`` dump contract (``rank/multi_head/multidnn.py:250``)."""
    predict_step = make_predict_step(bundle, mode=mode)
    for item in dataset:
        batch, dense_inputs = item[0], item[1]
        extra = item[4] if len(item) > 4 else None
        outputs = {k: v.cpu().numpy() for k, v in
                   predict_step(state, batch, dense_inputs).items()}
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
