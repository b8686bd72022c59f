"""The reference's train steps and scoring, for any configuration whose
module (``reference/<name>.py``) gives ``columns``, ``tables``,
``forward``, ``loss`` and ``predict_view``; a module that also gives
``dense`` (its dense features' keys and widths) gets the batch's dense
features as ``forward``'s ``dense``.

A train step: each column's rows gathered as a leaf, combined (a mean
column's masked mean; a sequence's masked rows and its mask), the tower
and its loss, the gradients of the loss with respect to the dense params
and the gathered rows, the rows' gradients and live-id counts summed into
each table, the lazy per-row update of the configuration's sparse
optimizer, dense Adam.  All in float32; ``tf32`` runs the products in
TF32 instead (the control).

``train`` returns what the comparison reads: each step's loss, the first
step's gradient of every leaf worked out from the optimizer's state after
that step (as for the program: Adam's first moment over 1 - b1, AdaGrad's
accumulator less its start, times D), each leaf's exact first gradient
norm, and the norm of each leaf's change over the steps.  A table is the
leaf ``table:<key>``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import common as C


def embed(model, m: dict, raw: Dict[str, torch.Tensor], batch: dict) -> dict:
    embs = {}
    for key, _, kind, _ in model.columns(m):
        mask = batch["mask"][key]
        if kind == "mean":
            embs[key] = C.mean_combine(raw[key], mask)
        else:
            embs[key] = (raw[key] * mask[..., None], mask)
    return embs


def dense_kwargs(model, batch: dict) -> dict:
    """``forward``'s dense features, ``{"dense": {key: (B, width)}}``, for
    a configuration whose module defines ``dense``; nothing for one that
    has none."""
    return {"dense": batch["dense"]} if hasattr(model, "dense") else {}


def _gather_all(model, m, tables, batch) -> Dict[str, torch.Tensor]:
    return {key: C.gather(tables[tkey], batch["ids"][key])
            for key, tkey, _, _ in model.columns(m)}


def state_grad_norms(m: dict, params_mu, tables_state, d_of) -> Dict[str, float]:
    """Each leaf's first gradient from optimizer state after one step."""
    opt = m["sparse_optimizer"]
    out = {k: float(torch.linalg.vector_norm(mu.double()) / (1 - m["dense_b1"]))
           for k, mu in params_mu.items()}
    for tkey, st in tables_state.items():
        if opt["kind"] == "adam":
            out[f"table:{tkey}"] = float(torch.linalg.vector_norm(st["m"].double())
                                         / (1 - opt["b1"]))
        else:
            sq = ((st["g2sum"].double() - opt["initial_g2sum"]) * d_of[tkey]).clamp(min=0)
            out[f"table:{tkey}"] = math.sqrt(float(sq.sum()))
    return out


def train(model, m: dict, init: dict, batches: List[dict], seeds: List[int], device,
          tf32: bool = False, sample0: int = 0) -> dict:
    """``len(batches)`` train steps from ``init`` ({"params", "tables"}:
    name -> tensor) on ``device``; step i draws its dropout from
    ``seeds[i]``."""
    opt = m["sparse_optimizer"]
    params = {k: v.to(device, torch.float32).clone() for k, v in init["params"].items()}
    tables = {k: v.to(device, torch.float32).clone() for k, v in init["tables"].items()}
    d_of = {k: t.shape[1] for k, t in tables.items()}
    if opt["kind"] == "adam":
        tstate = {k: {"m": torch.zeros_like(t), "v": torch.zeros_like(t),
                      "t": torch.zeros((t.shape[0], 1), device=device)}
                  for k, t in tables.items()}
    else:
        tstate = {k: {"g2sum": torch.full((t.shape[0], 1), opt["initial_g2sum"], device=device)}
                  for k, t in tables.items()}
    dense = C.Adam(m["dense_lr"], m["dense_b1"], m["dense_b2"], m["dense_eps"])
    losses, grad_state, grad_exact = [], {}, {}
    cols = model.columns(m)
    with C.precision(tf32):
        for step, (batch, seed) in enumerate(zip(batches, seeds)):
            raw = _gather_all(model, m, tables, batch)
            leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
            outputs = model.forward(m, leaves, embed(model, m, raw, batch), True, seed, sample0,
                                    **dense_kwargs(model, batch))
            loss = model.loss(m, outputs, batch["labels"], batch["weight"])
            grads = torch.autograd.grad(loss, list(leaves.values()) + list(raw.values()),
                                        allow_unused=True, materialize_grads=True)
            gp = dict(zip(leaves, grads[:len(leaves)]))
            graw = dict(zip(raw, grads[len(leaves):]))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                per_table: Dict[str, list] = {}
                for key, tkey, _, _ in cols:
                    per_table.setdefault(tkey, []).append(
                        (batch["ids"][key], batch["mask"][key], graw[key]))
                for tkey, parts in per_table.items():
                    grad, count = C.scatter_rows(tables[tkey].shape[0], parts)
                    if step == 0:
                        grad_exact[f"table:{tkey}"] = float(torch.linalg.vector_norm(grad.double()))
                    st = tstate[tkey]
                    if opt["kind"] == "adam":
                        C.lazy_adam(tables[tkey], st["m"], st["v"], st["t"], grad, count,
                                    opt["lr"], opt["b1"], opt["b2"], opt["eps"])
                    else:
                        C.lazy_adagrad(tables[tkey], st["g2sum"], grad, count, opt["lr"])
                if step == 0:
                    grad_exact.update({k: float(torch.linalg.vector_norm(g.double()))
                                       for k, g in gp.items()})
                dense.step(params, gp)
                if step == 0:
                    grad_state = state_grad_norms(m, dense.mu, tstate, d_of)
            del raw, leaves, outputs, loss, grads, gp, graw
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm((p - init["params"][k].to(device)).double()))
                  for k, p in params.items()}
        change.update({f"table:{k}": float(torch.linalg.vector_norm(
            (t - init["tables"][k].to(device)).double())) for k, t in tables.items()})
    return {"loss": losses, "grad_state": grad_state, "grad_exact": grad_exact,
            "change": change}


def predict(model, m: dict, init: dict, batch: dict, device, tf32: bool = False
            ) -> Dict[str, torch.Tensor]:
    """The scores of ``batch`` under ``init``'s weights, {task: (B, 1)}."""
    params = {k: v.to(device, torch.float32) for k, v in init["params"].items()}
    tables = {k: v.to(device, torch.float32) for k, v in init["tables"].items()}
    with torch.no_grad(), C.precision(tf32):
        raw = {key: tables[tkey][batch["ids"][key].long()]
               for key, tkey, _, _ in model.columns(m)}
        outputs = model.forward(m, params, embed(model, m, raw, batch), False,
                                **dense_kwargs(model, batch))
        return {k: v.float() for k, v in model.predict_view(m, outputs).items()}
