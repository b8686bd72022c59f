"""Two-phase fusion-weight search: PSO warm start + Gaussian-process
refinement (``gaussain/gaussian_process.py``).

Phase 1 (``init_param``/``update_operator``, ``gaussian_process.py:157-277``):
PSO over the 9 heads x 3 params with the Σa <= 30 simplex constraint
(``:114-117, 253-256``), inertia annealed 0.9 -> 0.4, the pull toward p_best
gated off while a particle has never scored (> -1).

Phase 2 (``:326-357``): fit a GP surrogate on the distinct top seeds, then
iterate a probability-of-improvement acquisition over jittered resamples of
the recent training points (``get_x_sample_data``, ``:85-120``).

The Spark broadcast + 600-partition map is replaced by the GaucEngine's
multiprocessing bucket map.
"""

from __future__ import annotations

import copy
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .gauc import GaucEngine

NGEN = 10                 # gaussian_model_utils.py:111
GAUSSIAN_NGEN = 200       # :112
POP_SIZE = 100            # :108
TRAIN_SEED_CNT = 1000     # :107
TRAIN_DATA_SIZE = 500     # :113
SUM_A_LIMIT = 30.0        # gaussian_process.py:114


def _flatten(params: Dict[str, List[float]], order: Sequence[str]) -> List[float]:
    out: List[float] = []
    for m in order:
        out += list(params[m])
    return out


def _unflatten(x: Sequence[float], order: Sequence[str]) -> Dict[str, List[float]]:
    return {m: [x[i * 3], x[i * 3 + 1], x[i * 3 + 2]] for i, m in enumerate(order)}


def _apply_sum_a_constraint(params: Dict[str, List[float]]) -> None:
    sum_a = sum(v[0] for v in params.values())
    if sum_a > SUM_A_LIMIT:
        for v in params.values():
            v[0] = round(v[0] * SUM_A_LIMIT / sum_a, 4)


class GPSearch:
    def __init__(self, engine: GaucEngine, is_coin_user: bool = False,
                 pop_size: int = POP_SIZE, ngen: int = NGEN,
                 gaussian_ngen: int = GAUSSIAN_NGEN,
                 rng: Optional[random.Random] = None, verbose: bool = False,
                 parallel: bool = False):
        self.engine = engine
        self.bound_x = engine.bound_x
        self.order = sorted(self.bound_x.keys())
        self.is_coin_user = is_coin_user
        self.pop_size = pop_size
        self.ngen = ngen
        self.gaussian_ngen = gaussian_ngen
        self.rng = rng or random.Random()
        self.verbose = verbose
        self.parallel = parallel

        self.pop_x: List[Dict[str, List[float]]] = []
        self.pop_v: List[Dict[str, List[float]]] = []
        self.p_best: List[Dict[str, List[float]]] = []
        self.p_best_result: List[float] = [-1.0] * pop_size
        self.g_best: Dict[str, List[float]] = {}
        self.g_best_result = -1.0
        self.history_x: List[Dict[str, List[float]]] = []
        self.history_y: List[float] = []

    def _reward(self, params, mark=False):
        if mark:
            self.engine.mark_base(params, parallel=self.parallel)
        r, detail = self.engine.reward(params, is_coin_user=self.is_coin_user,
                                       parallel=self.parallel)
        if self.verbose:
            print(f"reward={r} {detail[:120]}")
        return r

    # ---------------- phase 1: PSO ----------------

    def init_param(self) -> None:
        for i in range(self.pop_size):
            px, pv, pb = {}, {}, {}
            for m in self.order:
                lo, up = self.bound_x[m]["lower"], self.bound_x[m]["upper"]
                if i == 0:
                    key = "coin_param" if self.is_coin_user else "param"
                    a, b, c = self.bound_x[m][key]
                else:
                    a = round(self.rng.uniform(lo[0], up[0]), 4)
                    b = round(self.rng.uniform(lo[1], up[1]), 4)
                    c = round(self.rng.uniform(lo[2], up[2]), 4)
                px[m] = [a, b, c]
                pv[m] = [round(self.rng.uniform(0, 1), 4) for _ in range(3)]
                pb[m] = [0.0, 0.0, 0.0]
            _apply_sum_a_constraint(px)
            self.pop_x.append(px)
            self.pop_v.append(pv)
            self.p_best.append(pb)

        for i in range(self.pop_size):
            self.p_best[i] = copy.deepcopy(self.pop_x[i])
            fit = self._reward(self.p_best[i], mark=(i == 0))
            self.p_best_result[i] = fit
            self.history_x.append(copy.deepcopy(self.p_best[i]))
            self.history_y.append(fit)
            if fit > self.g_best_result:
                self.g_best = copy.deepcopy(self.p_best[i])
                self.g_best_result = fit

    def update_operator(self, cur_gen: int) -> None:
        w = 0.9 - (0.9 - 0.4) * cur_gen / max(self.ngen - 1, 1)
        for i in range(self.pop_size):
            c = 0 if self.p_best_result[i] == -1 else 1
            for m in self.order:
                for loc in range(3):
                    self.pop_v[i][m][loc] = round(
                        w * self.pop_v[i][m][loc]
                        + (1 - w) * (c * (self.p_best[i][m][loc] - self.pop_x[i][m][loc])
                                     + (self.g_best[m][loc] - self.pop_x[i][m][loc])), 4)
                    self.pop_x[i][m][loc] = round(
                        max(min(self.pop_x[i][m][loc] + self.pop_v[i][m][loc],
                                self.bound_x[m]["upper"][loc]),
                            self.bound_x[m]["lower"][loc]), 4)
            _apply_sum_a_constraint(self.pop_x[i])
            fit = self._reward(self.pop_x[i])
            self.history_x.append(copy.deepcopy(self.pop_x[i]))
            self.history_y.append(fit)
            if fit > self.p_best_result[i]:
                self.p_best[i] = copy.deepcopy(self.pop_x[i])
                self.p_best_result[i] = fit
            if fit > self.g_best_result:
                self.g_best = copy.deepcopy(self.pop_x[i])
                self.g_best_result = fit

    # ---------------- phase 2: GP ----------------

    def _sample_candidates(self, X: List[List[float]], seed_cnt: int
                           ) -> Tuple[List[List[float]], List[Dict[str, List[float]]]]:
        """get_x_sample_data (gaussian_process.py:85-120): jitter ONE head per
        seed around each of the last 10 training points."""
        xs, ps = [], []
        for i in range(seed_cnt):
            for train_sample in X[-10:]:
                params: Dict[str, List[float]] = {}
                flat: List[float] = []
                cnt = 0
                for mi, m in enumerate(self.order):
                    lo, up = self.bound_x[m]["lower"], self.bound_x[m]["upper"]
                    if cnt == seed_cnt % len(self.order):
                        a = min(max(round(train_sample[mi * 3] + self.rng.uniform(-1, 1), 4), lo[0]), up[0])
                        b = min(max(round(train_sample[mi * 3 + 1] + self.rng.uniform(-1, 1), 4), lo[1]), up[1])
                        c = min(max(round(train_sample[mi * 3 + 2] + self.rng.uniform(-1, 1), 4), lo[1]), up[2])
                    else:
                        a = train_sample[mi * 3]
                        b = train_sample[mi * 3 + 1]
                        c = train_sample[mi * 3 + 2]
                    params[m] = [a, b, c]
                    flat += [a, b, c]
                    cnt += 1
                _apply_sum_a_constraint(params)
                xs.append(_flatten(params, self.order))
                ps.append(params)
        return xs, ps

    def gaussian_phase(self) -> Tuple[Dict[str, List[float]], float]:
        from sklearn.gaussian_process import GaussianProcessRegressor
        from scipy.stats import norm

        # distinct top seeds from the PSO history (gaussian_process.py:302-326)
        hist_y = np.asarray(self.history_y)
        idx = hist_y.argsort()[-TRAIN_DATA_SIZE:]
        X, Y, seen = [], [], set()
        for i in idx:
            y = float(hist_y[i])
            if y in seen:
                continue
            seen.add(y)
            X.append(_flatten(self.history_x[i], self.order))
            Y.append(y)

        model = GaussianProcessRegressor()
        model.fit(X, Y)
        for _ in range(self.gaussian_ngen):
            xs, ps = self._sample_candidates(X, TRAIN_SEED_CNT // 10)
            mu_best = max(model.predict(X))
            mu, std = model.predict(xs, return_std=True)
            probs = norm.cdf((mu - mu_best) / (std + 1e-9))
            ix = int(np.argmax(probs))
            actual = self._reward(ps[ix])
            if actual == -1:
                continue
            X.append(xs[ix])
            Y.append(actual)
            model.fit(X, Y)
        best = int(np.argmax(Y))
        return _unflatten(X[best], self.order), float(Y[best])

    def run(self) -> Tuple[Dict[str, List[float]], float]:
        self.init_param()
        for gen in range(self.ngen):
            self.update_operator(gen)
            if self.verbose:
                print(f"pso gen {gen}: best={self.g_best_result}")
        return self.gaussian_phase()
