"""Weights from the seed, handed alike to the program and the reference,
and what the comparison reads back from the program's state.

``make_state`` draws every table storage and every dense parameter of the
program's bundle on the device with one generator, in a few large calls
(one a storage, one a parameter), in float32: tables by the
configuration's ``init.table`` rule, 2-D kernels glorot uniform over
their (in, out) fans, vectors uniform by ``init.vector`` (those named in
``init.ones`` 1).  The program gets a ``TrainState`` over those tensors
with its optimizers' own starting state; the reference gets a host copy
of each logical table (its rows of its storage) and of each parameter.

``read_grads`` and ``read_changes`` read the program's state the way the
reference's driver reads its own: the first gradient of each leaf from
the optimizer's state after one step, and each leaf's change since the
start.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .traffic import mix


def _table_draw(rule: dict, shape, gen, device) -> torch.Tensor:
    if rule["kind"] == "normal":
        w = torch.randn(shape, generator=gen, device=device).clamp_(-2.0, 2.0)
    elif rule["kind"] == "uniform":
        w = torch.rand(shape, generator=gen, device=device).mul_(2.0).sub_(1.0)
    else:
        raise ValueError(f"table init {rule['kind']!r}: expected 'normal' or 'uniform'")
    return w.mul_(rule["scale"])


def make_state(bundle, cfg: dict, model_tables: Dict[str, tuple], seed: int, device):
    """(the program's TrainState, the reference's init {"params",
    "tables"} on the host)."""
    from recommendsystem_tpu_torch.train.state import TrainState

    init_rule = cfg["init"]
    gen = torch.Generator(device=device).manual_seed(mix(seed, 0x77656967))
    eng = bundle.embedding
    tables = {}
    for skey, (rows, d) in sorted(eng.storage.items()):
        w = _table_draw(init_rule["table"], (rows, d), gen, device)
        tables[skey] = {"w": w, "opt": eng.sparse_opt.init_state((rows, d), device),
                        "show": torch.zeros((rows, 1), device=device)}
    params = {}
    for name, p in sorted(bundle.module.named_parameters()):
        if p.ndim == 2:
            a = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            x = torch.rand(tuple(p.shape), generator=gen, device=device).mul_(2 * a).sub_(a)
        elif name in init_rule["ones"]:
            x = torch.ones(tuple(p.shape), device=device)
        else:
            s = init_rule["vector"]["scale"]
            x = torch.rand(tuple(p.shape), generator=gen, device=device).mul_(2 * s).sub_(s)
        params[name] = x
    state = TrainState(params=params, opt_state=bundle.dense_optimizer.init(params),
                       tables=tables, step=0)
    init = {"params": {k: v.to("cpu", copy=True) for k, v in params.items()},
            "tables": {t: table_rows(eng, tables, t, "w", rows).to("cpu", copy=True)
                       for t, (rows, _) in model_tables.items()}}
    return state, init


def table_rows(eng, tables, tkey: str, field: str, rows: int) -> torch.Tensor:
    """The rows of logical table ``tkey`` in its storage's ``field`` (w,
    or an optimizer field)."""
    skey, offset, _ = eng.table_map[tkey]
    st = tables[skey]
    t = st[field] if field in ("w", "show") else st["opt"][field]
    return t[offset:offset + rows]


def read_grads(bundle, state, cfg: dict, model_tables) -> Dict[str, float]:
    """Each leaf's first gradient from the program's optimizer state after
    its first step (dense: Adam's mu / (1 - b1); tables: lazy Adam's m /
    (1 - b1), or AdaGrad's (g2sum - g2sum at start) times D, summed)."""
    m = cfg["model"]
    opt = m["sparse_optimizer"]
    out = {k: float(torch.linalg.vector_norm(mu.double()) / (1 - m["dense_b1"]))
           for k, mu in state.opt_state["mu"].items()}
    eng = bundle.embedding
    for tkey, (rows, d) in model_tables.items():
        if opt["kind"] == "adam":
            mt = table_rows(eng, state.tables, tkey, "m", rows).double()
            out[f"table:{tkey}"] = float(torch.linalg.vector_norm(mt) / (1 - opt["b1"]))
        else:
            g2 = table_rows(eng, state.tables, tkey, "g2sum", rows).double()
            out[f"table:{tkey}"] = math.sqrt(float(((g2 - opt["initial_g2sum"]) * d)
                                                   .clamp(min=0).sum()))
    return out


def read_changes(bundle, state, init: dict, model_tables) -> Dict[str, float]:
    """The norm of each leaf's change from ``init`` (on the host)."""
    dev = next(iter(state.params.values())).device
    out = {k: float(torch.linalg.vector_norm((p - init["params"][k].to(dev)).double()))
           for k, p in state.params.items()}
    for tkey, (rows, _) in model_tables.items():
        w = table_rows(bundle.embedding, state.tables, tkey, "w", rows)
        out[f"table:{tkey}"] = float(torch.linalg.vector_norm(
            (w.float() - init["tables"][tkey].to(dev)).double()))
    return out
