"""Streaming metrics as plain functions on tensors (init / update / compute).

Counterpart of ``recommendsystem_tpu/train/metrics.py``: Keras ``'acc'`` /
``BinaryAccuracy`` / ``AUC()``, tensornet's ``COPC()`` and ``CTR()``, and the
staytime EV metrics (bin accuracy, MAE and MSE of the expected value against
the raw watch time).

A state is a dict of tensors on one device: ``init(device)`` allocates every
key on its own (no two keys share storage), and ``update`` returns new
tensors and never writes into the state it was given, so a state can be
kept, shared by tasks or summed.  The state must lie on the device of the
outputs it is updated with; otherwise ``update`` raises
``MetricDeviceError`` (nothing copies a state silently).  ``update`` makes
no host sync, so an eval loop fetches the states once, at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


class MetricDeviceError(RuntimeError):
    """A metric state on another device than the outputs it is updated with."""


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    init: Callable[[Any], Dict[str, torch.Tensor]]
    update: Callable[..., Dict[str, torch.Tensor]]
    compute: Callable[[Dict[str, torch.Tensor]], torch.Tensor]


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def _check_device(name: str, state, y_pred: torch.Tensor) -> None:
    for key, t in state.items():
        if t.device != y_pred.device:
            raise MetricDeviceError(
                f"metric {name!r}: state {key!r} lies on {t.device}, the outputs on "
                f"{y_pred.device}; init the state on the outputs' device")


def _w(y: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.ones_like(y) if weight is None else torch.broadcast_to(weight, y.shape)


class _PerDevice:
    """A constant array, copied to each device once, when a state is made
    there, so that ``update`` makes no host-to-device copy."""

    def __init__(self, host: np.ndarray):
        self.host = host
        self._copies: Dict[torch.device, torch.Tensor] = {}

    def __call__(self, device: torch.device) -> torch.Tensor:
        if device not in self._copies:
            self._copies[device] = torch.from_numpy(self.host).to(device)
        return self._copies[device]


def _with_device_check(name, init, update, compute) -> Metric:
    def checked(s, y_true, y_pred, weight=None):
        _check_device(name, s, y_pred)
        return update(s, y_true, y_pred, weight)
    return Metric(name, init, checked, compute)


def binary_accuracy(threshold: float = 0.5, name: str = "acc") -> Metric:
    def init(device):
        return {"correct": _zero(device), "total": _zero(device)}

    def update(s, y_true, y_pred, weight=None):
        y_true = y_true.float()
        pred = (y_pred > threshold).float()
        w = _w(y_true, weight)
        return {"correct": s["correct"] + torch.sum(w * (pred == y_true)),
                "total": s["total"] + torch.sum(w)}

    return _with_device_check(name, init, update,
                              lambda s: s["correct"] / torch.clamp(s["total"], min=1.0))


def auc_thresholds(num_thresholds: int = 200) -> np.ndarray:
    """The Keras thresholds ``[-eps, 1/(n-1), ..., (n-2)/(n-1), 1+eps]`` in
    float32, bit for bit as the JAX package's ``jnp.linspace`` makes them
    (``torch.linspace`` and ``np.linspace`` round some of them otherwise)."""
    eps = 1e-7
    n = num_thresholds - 1
    inner = np.arange(n, dtype=np.float32) * np.float32(1.0 / n)
    return np.concatenate([np.array([-eps], np.float32), inner[1:],
                           np.array([1.0 + eps], np.float32)])


def auc(num_thresholds: int = 200, name: str = "auc") -> Metric:
    """Keras-style bucketed streaming ROC-AUC with trapezoidal interpolation."""
    thresholds = _PerDevice(auc_thresholds(num_thresholds))

    def init(device):
        state = {k: torch.zeros((thresholds.host.shape[0],), dtype=torch.float32,
                                device=device) for k in ("tp", "fp", "tn", "fn")}
        thresholds(state["tp"].device)
        return state

    def update(s, y_true, y_pred, weight=None):
        y_true = y_true.reshape(-1).float()
        y_pred = y_pred.reshape(-1)
        w = _w(y_true, None if weight is None else weight.reshape(-1))
        thr = thresholds(y_pred.device)
        above = (y_pred[None, :] > thr[:, None]).float()          # (T, N)
        pos = (y_true * w)[None, :]
        neg = ((1.0 - y_true) * w)[None, :]
        return {"tp": s["tp"] + torch.sum(above * pos, dim=1),
                "fp": s["fp"] + torch.sum(above * neg, dim=1),
                "fn": s["fn"] + torch.sum((1 - above) * pos, dim=1),
                "tn": s["tn"] + torch.sum((1 - above) * neg, dim=1)}

    def compute(s):
        tpr = s["tp"] / torch.clamp(s["tp"] + s["fn"], min=1e-12)
        fpr = s["fp"] / torch.clamp(s["fp"] + s["tn"], min=1e-12)
        # thresholds ascend -> tpr/fpr descend; integrate over fpr
        return torch.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0)

    return _with_device_check(name, init, update, compute)


def copc(name: str = "copc") -> Metric:
    """Click-Over-Predicted-Click calibration = sum(label)/sum(pred)."""
    def init(device):
        return {"label": _zero(device), "pred": _zero(device)}

    def update(s, y_true, y_pred, weight=None):
        y_true = y_true.float()
        w = _w(y_true, weight)
        return {"label": s["label"] + torch.sum(w * y_true),
                "pred": s["pred"] + torch.sum(w * y_pred.reshape(y_true.shape))}

    return _with_device_check(name, init, update,
                              lambda s: s["label"] / torch.clamp(s["pred"], min=1e-12))


def ctr(name: str = "ctr") -> Metric:
    """Label mean (tn.metric.CTR)."""
    def init(device):
        return {"label": _zero(device), "n": _zero(device)}

    def update(s, y_true, y_pred, weight=None):
        y_true = y_true.float()
        w = _w(y_true, weight)
        return {"label": s["label"] + torch.sum(w * y_true), "n": s["n"] + torch.sum(w)}

    return _with_device_check(name, init, update,
                              lambda s: s["label"] / torch.clamp(s["n"], min=1.0))


def _ev_pair(y_true, y_pred):
    """The EV output (the train head's last column) and the raw watch time
    in the last label column."""
    t = y_true[:, -1]
    p = y_pred[:, -1] if y_pred.ndim > 1 and y_pred.shape[-1] > 1 else y_pred.reshape(-1)
    return t.float(), p


def _ev_metric(name: str, err: Callable) -> Metric:
    def init(device):
        return {"err": _zero(device), "n": _zero(device)}

    def update(s, y_true, y_pred, weight=None):
        t, p = _ev_pair(y_true, y_pred)
        w = _w(t, None if weight is None else weight.reshape(t.shape))
        return {"err": s["err"] + torch.sum(w * err(t - p)), "n": s["n"] + torch.sum(w)}

    return _with_device_check(name, init, update,
                              lambda s: s["err"] / torch.clamp(s["n"], min=1.0))


def ev_mae(multiclass_num: int = 400, name: str = "mae") -> Metric:
    return _ev_metric(name, torch.abs)


def ev_mse(multiclass_num: int = 400, name: str = "mse") -> Metric:
    return _ev_metric(name, torch.square)


def bin_accuracy(bin_edges, multiclass_num: int = 400, name: str = "bin_acc") -> Metric:
    """staytime CustomAccuracy: the predicted distribution's argmax bin
    against the bin nearest the true watch time.  Both argmin and argmax
    take the first index on ties, as in the JAX package; the edges are
    float32, as ``jnp.asarray`` makes them."""
    edges = _PerDevice(np.asarray(bin_edges, np.float32))

    def init(device):
        state = {"correct": _zero(device), "n": _zero(device)}
        edges(state["n"].device)
        return state

    def update(s, y_true, y_pred, weight=None):
        true_wt = y_true[:, -1].float()
        true_bin = torch.argmin(torch.abs(edges(y_pred.device)[None, :] - true_wt[:, None]),
                                dim=1)
        pred_bin = torch.argmax(y_pred[:, :multiclass_num], dim=1)
        w = _w(true_wt, None if weight is None else weight.reshape(true_wt.shape))
        return {"correct": s["correct"] + torch.sum(w * (true_bin == pred_bin)),
                "n": s["n"] + torch.sum(w)}

    return _with_device_check(name, init, update,
                              lambda s: s["correct"] / torch.clamp(s["n"], min=1.0))


def init_metrics(metrics: Dict[str, list], device) -> Dict[str, list]:
    """{task: [state of each metric]} on ``device``, every state its own."""
    return {task: [m.init(device) for m in ms] for task, ms in metrics.items()}


def update_metrics(metrics: Dict[str, list], states, y_true, y_pred, weight=None):
    """``weight``: None, one (B, 1) tensor for every task, or {task: tensor}."""
    out = {}
    for task, ms in metrics.items():
        out[task] = [m.update(s, y_true[task], y_pred[task],
                              weight.get(task) if isinstance(weight, dict) else weight)
                     for m, s in zip(ms, states[task])]
    return out


def compute_metrics(metrics: Dict[str, list], states) -> Dict[str, Dict[str, torch.Tensor]]:
    """{task: {metric name: 0-d tensor}} on the states' device."""
    return {task: {m.name: m.compute(s) for m, s in zip(ms, states[task])}
            for task, ms in metrics.items()}
