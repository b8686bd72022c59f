"""Dense Adam of the port, in optax's order of operations.

The JAX package trains its dense parameters with ``optax.adam(lr, b1, b2,
eps)``.  ``Adam`` keeps optax's state one to one (``count``, ``mu``, ``nu``,
the moments named as the parameters) so ``bridge.py`` carries it across,
and applies the same arithmetic:

  mu = (1-b1) g + b1 mu;  nu = (1-b2) g^2 + b2 nu;  count += 1
  p += -lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)

with the bias corrections in float32, as optax takes them.  It updates
parameters and moments in place with multi-tensor (``torch._foreach_*``)
ops, a few launches for all parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Adam:
    learning_rate: float = 5e-5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update_(self, params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor], state: Dict[str, Any]):
        """One step; updates ``params`` and ``state``'s moments in place and
        returns (params, state)."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        count = state["count"] + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(count))
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1 - self.b2))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_mul_(upd, -self.learning_rate)
        torch._foreach_add_(p, upd)
        state["count"] = count
        return params, state
