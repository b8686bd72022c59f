"""The numbers that decide ``correct``, and their limits.

Training (the first steps that set-up drives through the window's own
call, against the reference from the same weights, batches and dropout
seeds):

- ``loss``: the largest relative gap of a step's loss;
- ``grad``: the median over the leaves of the gap between the two sides'
  norms of the first gradient as the optimizer got it, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger;
- ``change``: the median over the leaves of the same gap of each leaf's
  change over the steps, leaving out the leaves whose exact first
  gradient in the reference is under a thousandth of the median leaf's
  (they move by round-off alone);
- ``grad_group``: the gradient's gaps, each over the larger of the
  leaf's norm and its group's median norm, with the median taken within
  each group of leaves, and the largest group's median compared.  A group
  is the tables, or one kind of layer (``group``: a top-level module's
  name without its indices, so ``din_2125`` and ``din_2128`` are
  ``din``).  The median over all leaves is led by the tables, so a wrong
  backward in a few dense layers (staytime's DIN pools) moves it little;
  its group's median moves with it.  (A lost dense step moves the loss
  and ``change``; the group medians of the change swing with the kinks
  below too widely to hold.)

The worst leaf's gaps (``diagnostics``, printed by ``calibrate.py``, not
compared) swing from seed to seed, the same on every run of a seed: where
round-off puts a sample on the other side of a kink (a ReLU input at 0,
a sigmoid that saturates to exactly 1 at the output's clip) on one side
only, that sample's share of a leaf's gradient differs; and lazy Adam
steps an element by about its gradient's sign, so an element whose
gradient is near zero moves by round-off on one side and not the other.

Scoring:

- ``score``: over the sampled calls, every task and row, the largest
  |program - reference| over the larger of |reference| and the task's
  median |reference|.

Each number has its limit in ``limits/<cell>.json``, set from the
readings that ``calibrate.py`` gives (the lower one from sound runs, the
upper one from the control and the faults).
"""

from __future__ import annotations

import re
import statistics
from typing import Dict

import torch

TINY_GRAD = 1e-3


def _gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> Dict[str, float]:
    """Each leaf's |program - reference| over the larger of the reference's
    norm of the leaf and of the median leaf."""
    leaves = list(leaves)
    floor = statistics.median(ref[k] for k in leaves) if leaves else 0.0
    out = {}
    for k in leaves:
        den = max(ref[k], floor)
        out[k] = abs(prog.get(k, 0.0) - ref[k]) / den if den > 0 else abs(prog.get(k, 0.0))
    return out


def group(leaf: str) -> str:
    """A leaf's group: ``table`` for a table, else its top-level module's
    name with every ``_<digits>`` part left out."""
    if leaf.startswith("table:"):
        return "table"
    return re.sub(r"_\d+", "", leaf.split(".")[0])


def _group_medians(prog: Dict[str, float], ref: Dict[str, float], leaves) -> Dict[str, float]:
    """Each group's median gap, each gap over the larger of the leaf's norm
    and its group's median norm."""
    groups: Dict[str, list] = {}
    for k in leaves:
        groups.setdefault(group(k), []).append(k)
    return {g: statistics.median(_gaps(prog, ref, ks).values()) for g, ks in groups.items()}


def _moving(ref: dict):
    exact = ref["grad_exact"]
    med = statistics.median(exact.values())
    return [k for k in ref["change"] if exact.get(k, 0.0) >= TINY_GRAD * med]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"loss": [..], "grad_state": {leaf: norm},
    "change": {leaf: norm}}; ``ref`` also "grad_exact"."""
    inf = float("inf")
    if len(prog["loss"]) != len(ref["loss"]):
        return {k: inf for k in ("loss", "grad", "change", "grad_group")}
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    grad = _gaps(prog["grad_state"], ref["grad_state"], ref["grad_state"])
    groups = _group_medians(prog["grad_state"], ref["grad_state"], ref["grad_state"])
    change = _gaps(prog["change"], ref["change"], _moving(ref))
    return {"loss": loss, "grad": statistics.median(grad.values()) if grad else inf,
            "change": statistics.median(change.values()) if change else inf,
            "grad_group": max(groups.values()) if groups else inf}


def diagnostics(prog: dict, ref: dict) -> dict:
    """What ``calibrate.py`` prints beside the numbers (not compared): the
    median and the worst leaf's gap of the gradient and of the change, each
    group's median, and the three worst leaves of each with both sides'
    norms."""
    out = {}
    for key, leaves in (("grad_state", list(ref["grad_state"])), ("change", _moving(ref))):
        gaps = _gaps(prog[key], ref[key], leaves)
        top = sorted(gaps, key=gaps.get, reverse=True)[:3]
        out[key] = {"median": statistics.median(gaps.values()), "worst": gaps[top[0]],
                    "groups": _group_medians(prog[key], ref[key], leaves),
                    "top": [[k, gaps[k], prog[key].get(k, 0.0), ref[key][k],
                             ref["grad_exact"].get(k, 0.0)] for k in top]}
    return out


def score_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    worst = 0.0
    for task, r in ref.items():
        p = torch.as_tensor(prog[task]).to(r.device, torch.float32).reshape(r.shape)
        if p.shape != r.shape or not bool(torch.isfinite(p).all()):
            return float("inf")
        floor = float(r.abs().median())
        den = torch.clamp(r.abs(), min=floor) if floor > 0 else r.abs().clamp(min=1e-30)
        worst = max(worst, float(((p - r).abs() / den).max()))
    return worst


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a missing one fails)."""
    return all(k in numbers and numbers[k] <= lim for k, lim in limits.items())
