"""Per-row sparse optimizers for embedding tables: lazy Adam and AdaGrad.

Counterpart of ``SparseAdam`` and ``SparseAdaGrad`` in
``recommendsystem_tpu/embedding/optimizers.py``: per-row state lives beside
the table and updates are lazy, so only rows that appeared in the batch
move.  ``row_mask`` is (rows, 1) float {0, 1}: 1 where the row appeared.
Both are plain PyTorch and the oracles of the lazy passes on the card:
``SparseAdam`` of K8 (``embedding/packed.py::sparse_adam_update_group``),
``SparseAdaGrad`` of K9 (``embedding/packed.py::sparse_adagrad_update_group``).

The arithmetic is float32.  ``SparseAdam.state_dtype`` is the type its
moments are stored in (float32 or bfloat16): ``update`` and ``update_rows``
compute from the float32 values of the stored moments and cast only what
they return for storing, so the step comes from the unrounded moments, as
in the JAX package.  The callers pass w in float32 and store the result in
the table's own type (``EmbeddingFeatures.table_dtype``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass(frozen=True)
class SparseAdam:
    learning_rate: float = 5e-5
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    # the storage type of the per-row moments m and v (float32 or
    # bfloat16); the arithmetic stays float32
    state_dtype: Any = torch.float32

    def init_state(self, shape, device=None) -> Dict[str, torch.Tensor]:
        """Zero moments in ``state_dtype`` and a zero float32 per-row step
        counter ``t``: rows absent from a batch do not advance it, so bias
        correction is per row."""
        return {"m": torch.zeros(shape, dtype=self.state_dtype, device=device),
                "v": torch.zeros(shape, dtype=self.state_dtype, device=device),
                "t": torch.zeros((shape[0], 1), dtype=torch.float32,
                                 device=device)}

    def table_init(self, generator: torch.Generator, shape,
                   dtype=torch.float32) -> torch.Tensor:
        """TF ``embedding_column`` default: truncated normal on [-2, 2]
        divided by sqrt(D), drawn in float32 on the generator's device and
        cast to ``dtype``."""
        w = torch.empty(shape, dtype=torch.float32, device=generator.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return w.div_(shape[1] ** 0.5).to(dtype)

    def _moments(self, m_prev, v_prev, grad, t):
        m = self.beta1 * m_prev + (1 - self.beta1) * grad
        v = self.beta2 * v_prev + (1 - self.beta2) * torch.square(grad)
        t_safe = torch.clamp(t, min=1.0)
        m_hat = m / (1 - self.beta1 ** t_safe)
        v_hat = v / (1 - self.beta2 ** t_safe)
        step = self.learning_rate * m_hat / (torch.sqrt(v_hat) + self.epsilon)
        return m, v, step

    def update(self, w, grad, state, row_mask):
        """Whole-table lazy update of a float32 ``w``: rows with ``row_mask
        > 0`` step t, m, v and w; the others pass through bit-identical.
        Returns (w, state), m and v in ``state_dtype``."""
        t = state["t"] + row_mask
        m_prev, v_prev = state["m"].float(), state["v"].float()
        m, v, step = self._moments(m_prev, v_prev, grad, t)
        live = row_mask > 0
        return (torch.where(live, w - step, w),
                {"m": torch.where(live, m, m_prev).to(self.state_dtype),
                 "v": torch.where(live, v, v_prev).to(self.state_dtype), "t": t})

    def update_rows(self, w_rows, grad_rows, state_rows, valid):
        """Row-sliced update of gathered float32 rows; ``valid`` (n, 1) {0,
        1} marks real rows.  m and v come back in ``state_dtype``."""
        t = state_rows["t"] + valid
        m_prev, v_prev = state_rows["m"].float(), state_rows["v"].float()
        m, v, step = self._moments(m_prev, v_prev, grad_rows, t)
        live = valid > 0
        return (w_rows - valid * step,
                {"m": torch.where(live, m, m_prev).to(self.state_dtype),
                 "v": torch.where(live, v, v_prev).to(self.state_dtype), "t": t})


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

    def table_init(self, generator: torch.Generator, shape,
                   dtype=torch.float32) -> torch.Tensor:
        """Uniform on [-initial_scale, initial_scale), drawn in float32 on
        the generator's device and cast to ``dtype``."""
        w = torch.empty(shape, dtype=torch.float32, device=generator.device)
        return w.uniform_(-self.initial_scale, self.initial_scale,
                          generator=generator).to(dtype)

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


def make_sparse_optimizer(name: str, **kwargs):
    """``SparseAdam(**kwargs)`` for ``"adam"``, ``SparseAdaGrad(**kwargs)``
    for ``"adagrad"`` (any case); another name raises ``ValueError``."""
    name = name.lower()
    if name == "adam":
        return SparseAdam(**kwargs)
    if name == "adagrad":
        return SparseAdaGrad(**kwargs)
    raise ValueError(f"unknown sparse optimizer {name!r}")
