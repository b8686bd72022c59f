"""Per-row sparse optimizers for embedding tables: lazy Adam and AdaGrad.

Counterpart of ``SparseAdam`` and ``SparseAdaGrad`` in
``recommendsystem_tpu/embedding/optimizers.py``: per-row state lives beside
the table and updates are lazy, so only rows that appeared in the batch
move.  ``row_mask`` is (rows, 1) float {0, 1}: 1 where the row appeared.
Both are plain PyTorch and the oracles of the lazy passes on the card:
``SparseAdam`` of K8 (``embedding/packed.py::sparse_adam_update_group``),
``SparseAdaGrad`` of K9 (``embedding/packed.py::sparse_adagrad_update_group``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class SparseAdam:
    learning_rate: float = 5e-5
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, shape, device=None) -> Dict[str, torch.Tensor]:
        """Zero moments and a zero per-row step counter ``t``: rows absent
        from a batch do not advance it, so bias correction is per row."""
        return {"m": torch.zeros(shape, dtype=torch.float32, device=device),
                "v": torch.zeros(shape, dtype=torch.float32, device=device),
                "t": torch.zeros((shape[0], 1), dtype=torch.float32,
                                 device=device)}

    def table_init(self, generator: torch.Generator, shape) -> torch.Tensor:
        """TF ``embedding_column`` default: truncated normal on [-2, 2]
        divided by sqrt(D), on the generator's device."""
        w = torch.empty(shape, dtype=torch.float32, device=generator.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return w.div_(shape[1] ** 0.5)

    def _moments(self, m_prev, v_prev, grad, t):
        m = self.beta1 * m_prev + (1 - self.beta1) * grad
        v = self.beta2 * v_prev + (1 - self.beta2) * torch.square(grad)
        t_safe = torch.clamp(t, min=1.0)
        m_hat = m / (1 - self.beta1 ** t_safe)
        v_hat = v / (1 - self.beta2 ** t_safe)
        step = self.learning_rate * m_hat / (torch.sqrt(v_hat) + self.epsilon)
        return m, v, step

    def update(self, w, grad, state, row_mask):
        """Whole-table lazy update: rows with ``row_mask > 0`` step t, m, v
        and w; the others pass through bit-identical.  Returns (w, state)."""
        t = state["t"] + row_mask
        m, v, step = self._moments(state["m"], state["v"], grad, t)
        live = row_mask > 0
        return (torch.where(live, w - step, w),
                {"m": torch.where(live, m, state["m"]),
                 "v": torch.where(live, v, state["v"]), "t": t})

    def update_rows(self, w_rows, grad_rows, state_rows, valid):
        """Row-sliced update of gathered rows; ``valid`` (n, 1) {0, 1} marks
        real rows."""
        t = state_rows["t"] + valid
        m, v, step = self._moments(state_rows["m"], state_rows["v"],
                                   grad_rows, t)
        live = valid > 0
        return (w_rows - valid * step,
                {"m": torch.where(live, m, state_rows["m"]),
                 "v": torch.where(live, v, state_rows["v"]), "t": t})


@dataclasses.dataclass(frozen=True)
class SparseAdaGrad:
    """Parameter-server AdaGrad: one ``g2sum`` accumulator per row, which
    adds the mean of the row's squared gradient.  ``feature_drop_show`` is
    the admission threshold of ``EmbeddingFeatures.maybe_evict`` (-1 keeps
    every row)."""

    learning_rate: float = 5e-3
    initial_g2sum: float = 0.1
    initial_scale: float = 0.1
    feature_drop_show: float = -1.0

    def init_state(self, shape, device=None) -> Dict[str, torch.Tensor]:
        """``g2sum`` (rows, 1) at ``initial_g2sum``."""
        return {"g2sum": torch.full((shape[0], 1), self.initial_g2sum,
                                    dtype=torch.float32, device=device)}

    def table_init(self, generator: torch.Generator, shape) -> torch.Tensor:
        """Uniform on [-initial_scale, initial_scale), on the generator's
        device."""
        w = torch.empty(shape, dtype=torch.float32, device=generator.device)
        return w.uniform_(-self.initial_scale, self.initial_scale,
                          generator=generator)

    def update(self, w, grad, state, row_mask):
        """Whole-table lazy update: rows with ``row_mask > 0`` add
        mean(grad^2) to g2sum and step ``w -= lr * grad / sqrt(g2sum)``; the
        others pass through bit-identical.  Returns (w, state)."""
        live = row_mask > 0
        g2 = torch.square(grad).mean(dim=-1, keepdim=True)
        g2sum = torch.where(live, state["g2sum"] + g2, state["g2sum"])
        step = self.learning_rate * grad / torch.sqrt(g2sum)
        return torch.where(live, w - step, w), {"g2sum": g2sum}

    def update_rows(self, w_rows, grad_rows, state_rows, valid):
        """Row-sliced update of gathered rows; ``valid`` (n, 1) {0, 1} marks
        real rows."""
        g2 = torch.square(grad_rows).mean(dim=-1, keepdim=True)
        g2sum = state_rows["g2sum"] + valid * g2
        step = self.learning_rate * grad_rows / torch.sqrt(g2sum)
        return w_rows - valid * step, {"g2sum": g2sum}
