"""Per-user GAUC evaluation over model predictions.

Counterpart of ``recommendsystem_tpu/train/gauc_eval.py``: run the predict
step over a dataset carrying user ids, then take the per-user
impression-weighted GAUC that drives the reference's fusion search
(``gaussain/gaussian_model_utils.py:242-280``) for each task head, either
offline on the host (``evaluate_gauc``, ``search.gauc.group_auc``) or
streaming on the device (``evaluate_gauc_streaming``).

The streaming step takes the predict step's packed lookup (the fused folds
and, for sequences, the DIN pool gathering its rows), where the JAX step
unpacks every table and takes the classic lookup: the embeddings are the
same, and no table is copied a call.

Datasets yield ``(batch, dense_inputs, labels, weight, extras)`` with
``extras[user_key]`` the grouping ids (numpy or a tensor).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Iterable, Optional

import numpy as np
import torch

from ..search.gauc import group_auc
from .state import TrainState
from .step import _lookup_for_mode, apply_model, make_predict_step
from .streaming_gauc import StreamingGauc

if TYPE_CHECKING:
    from ..models.base import ModelBundle


def _per_task(gauc, tasks):
    """Normalize ``gauc`` to {task: metric}: one metric for all tasks, or a
    dict mixing ROC (``StreamingGauc``) and continuous-label
    (``StreamingSpearmanGauc``) engines per head.  A dict must cover every
    requested task (a typo'd key would otherwise drop a head silently)."""
    if isinstance(gauc, dict):
        missing = [t for t in tasks if t not in gauc]
        if missing:
            raise KeyError(f"gauc dict has no metric for task(s) {missing}; "
                           f"provided keys: {sorted(gauc)}")
        return {t: gauc[t] for t in tasks}
    return {t: gauc for t in tasks}


def make_gauc_eval_step(bundle: "ModelBundle", gauc, mode: str = "local",
                        tasks: Optional[tuple] = None):
    """Returns ``step(state, batch, dense_inputs, labels, user_ids,
    gauc_states) -> gauc_states`` under ``torch.inference_mode()``: the
    predict step's lookup and tower, ``predict_view``, then each head's
    streaming-GAUC update on the last column of its output and label, all
    on the device.  ``gauc`` is one metric or a {task: metric} dict;
    ``gauc_states`` is {task: metric.init(device)} and is additive."""
    per_task = _per_task(gauc, tuple(tasks or bundle.metrics))

    def step(state: TrainState, batch, dense_inputs, labels, user_ids, gauc_states):
        with torch.inference_mode():
            embs = _lookup_for_mode(bundle, state.tables, batch, mode)
            outputs = bundle.predict_view(apply_model(bundle, state.params, embs,
                                                      dense_inputs, training=False))
            out = {}
            for task, s in gauc_states.items():
                pred = outputs[task].reshape(outputs[task].shape[0], -1)[:, -1]
                y = labels[task].reshape(labels[task].shape[0], -1)[:, -1]
                out[task] = per_task[task].update(s, y, pred, user_ids)
        return out

    return step


def _user_tensor(ids, device) -> torch.Tensor:
    if isinstance(ids, torch.Tensor):
        return ids.to(device)
    return torch.from_numpy(np.asarray(ids)).to(device)


def evaluate_gauc_streaming(bundle: "ModelBundle", dataset: Iterable,
                            state: TrainState, user_key: str = "user_id",
                            mode: str = "local", tasks: Optional[tuple] = None,
                            gauc=None) -> Dict[str, float]:
    """The streaming variant of :func:`evaluate_gauc`: no prediction dump;
    the per-user state stays on the device as bucketed histograms, and the
    values are copied to the host once, at the end.  ``gauc``: one metric
    for every head, or {task: metric} mixing ``StreamingGauc`` (ROC heads)
    with ``StreamingSpearmanGauc`` (continuous heads, e.g. the staytime EV
    output with its label and prediction ranges)."""
    gauc = gauc or StreamingGauc()
    task_list = tuple(tasks or bundle.metrics)
    per_task = _per_task(gauc, task_list)
    step = make_gauc_eval_step(bundle, gauc, mode=mode, tasks=task_list)
    # states from the requested tasks, not the first batch's label keys: a
    # task missing from a batch fails loudly
    states = {t: m.init(bundle.device) for t, m in per_task.items()}
    saw_data = False
    for item in dataset:
        batch, dense_inputs, labels, _weight, extras = item
        missing = [t for t in states if t not in labels]
        if missing:
            raise KeyError(f"batch labels missing task(s) {missing}; "
                           f"label keys: {sorted(labels)}")
        users = _user_tensor(extras[user_key], bundle.device)
        states = step(state, batch, dense_inputs, labels, users, states)
        saw_data = True
    if not saw_data:
        return {}
    values = torch.stack([per_task[t].compute(s) for t, s in states.items()]).cpu().tolist()
    return dict(zip(states, values))


def evaluate_gauc(bundle: "ModelBundle", dataset: Iterable, state: TrainState,
                  user_key: str = "user_id", mode: str = "local",
                  spearman_tasks: tuple = ()) -> Dict[str, float]:
    """Task -> GAUC by ``search.gauc.group_auc`` over the predict step's
    outputs (last column) and labels (last column), grouped by
    ``extras[user_key]``; ``spearman_tasks`` take the consistency AUC."""
    predict_step = make_predict_step(bundle, mode=mode)
    preds: Dict[str, list] = {}
    labels_acc: Dict[str, list] = {}
    users: list = []
    for item in dataset:
        batch, dense_inputs, labels, _weight, extras = item
        outputs = predict_step(state, batch, dense_inputs)
        ids = extras[user_key]
        users.append(ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids))
        n = len(users[-1])
        for task in bundle.metrics:
            if task not in outputs or task not in labels:
                continue
            preds.setdefault(task, []).append(
                outputs[task].cpu().numpy().reshape(n, -1)[:, -1])
            labels_acc.setdefault(task, []).append(
                labels[task].cpu().numpy().reshape(n, -1)[:, -1])

    user_ids = np.concatenate(users)
    out = {}
    for task in preds:
        p = np.concatenate(preds[task])
        y = np.concatenate(labels_acc[task])
        total, n = group_auc(y, p, user_ids, is_spearman=task in spearman_tasks)
        out[task] = total / n if n else 0.0
    return out
