"""Particle-swarm search of post-rank score-fusion weights (``pso/pso.py``).

Fusion score over 6 params (``pso.py:44-52``):
    score = (1 + a0·anctr)^a1 · (1 + a2·cardctr)^a3 ·
            (1 + a4·cvr·op(anctr, cardctr))^a5,   op = max or sum
Fitness = weighted AUC-delta reward vs a base parameterization
(``:71-83``); velocity/position update with learning factors c1=c2=2 and
inertia annealed 0.5 -> 0.2 (``:121-149``).

Re-design: the per-particle fusion + AUC evaluation is fully vectorized over
the sample table (NumPy), replacing the reference's per-row Python loop; the
particle cache keeps the lru_cache-by-position behaviour (``:67-69``).
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .metrics import binary_label_auc, float_label_auc

BASE_PARAMS = [7.2131, 4.6267, 8.6074, 4.3671, 533.4611, 9.4533]   # pso.py:54
DEFAULT_LOW = [0.00001, 1, 0.00001, 1, 0.0000001, 1]               # pso.py:171
DEFAULT_UP = [10, 10, 10, 10, 10000, 20]                           # pso.py:172


def calc_fusion_scores(data: np.ndarray, ind_var: Sequence[float],
                       max_op: bool = False, st_term: bool = True) -> np.ndarray:
    """Vectorized fusion over the (N, 8) sample table
    [st_p, st_l, anctr_p, anctr_l, cardctr_p, cardctr_l, cvr_p, cvr_l]."""
    anctr_p, cardctr_p, cvr_p = data[:, 2], data[:, 4], data[:, 6]
    score = np.power(1.0 + ind_var[0] * anctr_p, ind_var[1])
    score = score * np.power(1.0 + ind_var[2] * cardctr_p, ind_var[3])
    coupled = np.maximum(anctr_p, cardctr_p) if max_op else (anctr_p + cardctr_p)
    score = score * np.power(1.0 + ind_var[4] * cvr_p * coupled, ind_var[5])
    return score


class PSO:
    def __init__(self, ngen: int, pop_size: int,
                 low: Sequence[float] = tuple(DEFAULT_LOW),
                 up: Sequence[float] = tuple(DEFAULT_UP),
                 data: Optional[Sequence[Sequence[float]]] = None,
                 rng: Optional[random.Random] = None,
                 verbose: bool = True):
        self.base: Optional[List[float]] = None
        self.ngen = ngen
        self.pop_size = pop_size
        self.var_num = len(low)
        self.bound = [list(low), list(up)]
        self.data = np.asarray(data, dtype=np.float64) if data is not None else None
        self.rng = rng or random.Random()
        self.verbose = verbose
        self._cache: Dict[Tuple[float, ...], float] = {}

        self.pop_x = np.zeros((pop_size, self.var_num))
        self.pop_v = np.zeros((pop_size, self.var_num))
        self.p_best = np.zeros((pop_size, self.var_num))
        self.g_best = np.zeros((self.var_num,))

    # ---------------- fitness ----------------

    def sub_aucs(self, ind_var, max_op=True) -> List[float]:
        d = self.data
        scores = calc_fusion_scores(d, ind_var, max_op=False)
        st_auc = float_label_auc(scores, d[:, 1])
        anchor_auc = binary_label_auc(scores, d[:, 3])
        card_auc = binary_label_auc(scores, d[:, 5])
        cvr_auc = binary_label_auc(scores, d[:, 7])
        return [st_auc, anchor_auc, card_auc, cvr_auc]

    def reward(self, st_auc, anchor_auc, card_auc, cvr_auc) -> float:
        """pso.py:71-83 — asymmetric weights around the base point."""
        if not self.base:
            return anchor_auc * 1 + card_auc * 1.5 + cvr_auc * 10
        positives = [0.0, 0, 0, 6.0]
        negatives = [2.0, 1, 1, 2.0]
        diff = [st_auc - self.base[0], anchor_auc - self.base[1],
                card_auc - self.base[2], cvr_auc - self.base[3]]
        return sum(positives[i] * d if d > 0 else negatives[i] * d
                   for i, d in enumerate(diff))

    def fitness(self, ind_var, flush_out: bool = True) -> float:
        aucs = self.sub_aucs(ind_var)
        out = self.reward(*aucs)
        if flush_out and self.verbose:
            print("st_auc: %s, anchor_auc: %s, card_auc: %s, cvr_auc: %s, "
                  "fitness: %s" % tuple(round(x, 4) for x in aucs + [out]))
        return out

    def fitness_cached(self, ind_var) -> float:
        key = tuple(float(x) for x in ind_var)
        if key not in self._cache:
            self._cache[key] = self.fitness(np.asarray(ind_var), flush_out=False)
        return self._cache[key]

    def base_auc(self, params: Sequence[float] = tuple(BASE_PARAMS),
                 max_op: bool = False) -> List[float]:
        """Record the base point's sub-AUCs (pso.py:54-65)."""
        self.base = self.sub_aucs(np.asarray(params), max_op=max_op)
        return self.base

    # ---------------- swarm ----------------

    def init(self) -> None:
        best = -math.inf
        for i in range(self.pop_size):
            for j in range(self.var_num):
                self.pop_x[i, j] = self.rng.uniform(self.bound[0][j], self.bound[1][j])
                self.pop_v[i, j] = self.rng.uniform(0, 1)
            self.p_best[i] = self.pop_x[i]
            fit = self.fitness_cached(self.p_best[i])
            if fit > best:
                self.g_best = self.p_best[i].copy()
                best = fit

    def update_operator(self, cur_gen: int) -> None:
        c1 = c2 = 2.0
        w = 0.5 - (0.5 - 0.2) * cur_gen / max(self.ngen - 1, 1)   # pso.py:127
        for i in range(self.pop_size):
            self.pop_v[i] = (w * self.pop_v[i]
                             + c1 * self.rng.uniform(0, 1) * (self.p_best[i] - self.pop_x[i])
                             + c2 * self.rng.uniform(0, 1) * (self.g_best - self.pop_x[i]))
            self.pop_x[i] = np.clip(self.pop_x[i] + self.pop_v[i],
                                    self.bound[0], self.bound[1])
            fit = self.fitness_cached(self.pop_x[i])
            if fit > self.fitness_cached(self.p_best[i]):
                self.p_best[i] = self.pop_x[i].copy()
            if fit > self.fitness_cached(self.g_best):
                self.g_best = self.pop_x[i].copy()

    def main(self) -> Tuple[float, np.ndarray]:
        self.init()
        ng_best = np.zeros((self.var_num,))
        for gen in range(self.ngen):
            self.update_operator(gen)
            if self.fitness_cached(self.g_best) > self.fitness_cached(ng_best):
                ng_best = self.g_best.copy()
            if self.verbose:
                print("############ Generation {} ############".format(gen + 1))
                print("best position: {}".format(ng_best))
                print("best fitness:  {}".format(self.fitness_cached(ng_best)))
        return self.fitness_cached(ng_best), ng_best
