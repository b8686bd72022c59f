"""The port's offline fusion search (``recommendsystem_tpu_torch/search/``,
its own numpy copy) against the JAX package's ``search/`` on the same
inputs and seeds, mirroring ``tests/test_search.py``: the offline AUCs,
``group_auc`` and the group-size filter, the mixed score, ``GaucEngine``
and ``DurationBucketedGaucEngine`` (GAUCs, rewards, gates), PSO and
``GPSearch`` from the same ``random.Random`` seeds, ``Reader`` and both CLI
commands on files written in the test.  Both sides compute in float64 numpy
by the same code, so every result is held equal."""

import io
import random
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from recommendsystem_tpu import search as J
from recommendsystem_tpu.search import cli as jax_cli
from recommendsystem_tpu.search.gauc import DurationBucketedGaucEngine as JaxDurationEngine
from recommendsystem_tpu_torch import search as S
from recommendsystem_tpu_torch.search import cli
from recommendsystem_tpu_torch.search.gauc import DurationBucketedGaucEngine

ROOT = Path(__file__).resolve().parent.parent


def _score_log(n=400, seed=0):
    """Synthetic PSO sample table: the anchor label driven by anctr_p."""
    rng = np.random.default_rng(seed)
    anctr_p = rng.uniform(0, 0.2, n)
    card_p = rng.uniform(0, 0.1, n)
    cvr_p = rng.uniform(0, 0.05, n)
    st_p = rng.uniform(0, 1, n)
    anctr_l = (rng.uniform(size=n) < anctr_p * 4).astype(int)
    card_l = (rng.uniform(size=n) < card_p * 5).astype(int)
    cvr_l = (rng.uniform(size=n) < cvr_p * 10).astype(int)
    st_l = st_p * 50 + rng.normal(0, 5, n)
    return np.stack([st_p, st_l, anctr_p, anctr_l, card_p, card_l, cvr_p, cvr_l], axis=1)


def _gauc_fixture(n=2000, users=40, seed=0):
    rng = np.random.default_rng(seed)
    heads = list(S.default_bound_x().keys())
    user_ids = rng.integers(0, users, n)
    quality = rng.uniform(size=n)
    scores, labels = {}, {}
    for h in heads:
        s = np.clip(quality * 0.5 + rng.uniform(0, 0.5, n), 1e-4, 1)
        scores[h] = s
        labels[h] = (quality * 100 + rng.normal(0, 10, n) if h == "staytime"
                     else (rng.uniform(size=n) < s).astype(float))
    return scores, labels, user_ids


def test_offline_aucs_match_jax():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 400)
    p = rng.uniform(size=400)
    assert S.binary_label_auc(p, y) == J.binary_label_auc(p, y)
    ties = np.round(p, 1)                          # ties resolved by sort order
    assert S.binary_label_auc(ties, y) == J.binary_label_auc(ties, y)
    labels = rng.uniform(size=300)
    assert S.float_label_auc(p[:300], labels) == J.float_label_auc(p[:300], labels)
    assert S.Metrics.binaryIntLabelAuc([0.1, 0.2, 0.14], [1, 0, 1]) == 0.0
    assert S.Metrics.floatLabelAuc([0.9, 0.5, 0.3, 0.1], [40.0, 30.0, 20.0, 10.0]) == 1.0
    assert S.binary_label_auc([0.1, 0.2], [1, 1]) == J.binary_label_auc([0.1, 0.2], [1, 1])


def test_group_auc_filter_and_mixed_score_match_jax():
    scores, labels, users = _gauc_fixture(n=800, users=30, seed=1)
    for spearman, head in ((False, "finish"), (True, "staytime")):
        assert S.group_auc(labels[head], scores[head], users, is_spearman=spearman) == \
            J.group_auc(labels[head], scores[head], users, is_spearman=spearman)
    users2 = np.array([1] * 5 + [2] * 25 + [3] * 250)
    np.testing.assert_array_equal(S.filter_user_group_sizes(users2, 20, 200),
                                  J.filter_user_group_sizes(users2, 20, 200))
    params = {h: S.default_bound_x()[h]["param"] for h in scores}
    np.testing.assert_array_equal(S.cal_mixed_score(params, scores),
                                  J.cal_mixed_score(params, scores))
    with pytest.raises(ValueError, match="impression id num"):
        S.group_auc(labels["finish"], scores["finish"], users[:-1])


def test_gauc_engine_matches_jax():
    scores, labels, users = _gauc_fixture()
    bounds = S.default_bound_x(), J.default_bound_x()
    assert bounds[0] == bounds[1]
    engines = [mod.GaucEngine(scores=scores, labels=labels, user_ids=users, bound_x=b,
                              num_buckets=4) for mod, b in zip((S, J), bounds)]
    params = {h: bounds[0][h]["param"] for h in bounds[0]}
    assert engines[0].mark_base(params) == engines[1].mark_base(params)
    other = {h: [p[0] * 0.9, p[1], p[2] * 1.1] for h, p in params.items()}
    for coin in (False, True):
        assert engines[0].reward(other, is_coin_user=coin) == \
            engines[1].reward(other, is_coin_user=coin)
    for b in bounds:
        b["finish"]["gauc"] = 1.1                 # unreachable base: the gate trips
    got, want = engines[0].reward(params), engines[1].reward(params)
    assert got == want and got[0] == -1.0 and "finish" in got[1]


def test_duration_bucketed_engine_matches_jax():
    scores, labels, users = _gauc_fixture(n=3000, users=40)
    duration = np.random.default_rng(3).integers(0, 2, 3000)
    bounds = S.default_bound_x(), J.default_bound_x()
    engines = [cls(scores=scores, labels=labels, user_ids=users, duration_bucket=duration,
                   bound_x=b, num_buckets=4)
               for cls, b in zip((DurationBucketedGaucEngine, JaxDurationEngine), bounds)]
    params = {h: bounds[0][h]["param"] for h in bounds[0]}
    for e in engines:
        e.mark_base(params)
    assert bounds[0] == bounds[1]
    other = {h: [p[0] * 1.05, p[1], p[2]] for h, p in params.items()}
    assert engines[0].reward_v2(other) == engines[1].reward_v2(other)
    for b in bounds:
        b["finish"]["gauc_1"] = 1.5
    got = engines[0].reward_v2(params)
    assert got == engines[1].reward_v2(params) and got[0] == -1.0


def test_pso_with_the_same_seed_gives_the_same_search():
    data = _score_log()
    np.testing.assert_array_equal(S.calc_fusion_scores(data, S.BASE_PARAMS, max_op=True),
                                  J.calc_fusion_scores(data, J.BASE_PARAMS, max_op=True))
    runs = []
    for mod in (S, J):
        pso = mod.PSO(ngen=3, pop_size=8, data=data, rng=random.Random(0), verbose=False)
        base = pso.base_auc()
        runs.append((base, *pso.main()))
    assert runs[0][0] == runs[1][0]
    assert runs[0][1] == runs[1][1]
    np.testing.assert_array_equal(runs[0][2], runs[1][2])
    assert np.isfinite(runs[0][1]) and len(runs[0][2]) == 6


def test_gp_search_with_the_same_seed_gives_the_same_result():
    scores, labels, users = _gauc_fixture(n=600, users=12)
    out = []
    for mod in (S, J):
        eng = mod.GaucEngine(scores=scores, labels=labels, user_ids=users,
                             bound_x=mod.default_bound_x(), num_buckets=2)
        search = mod.GPSearch(eng, pop_size=4, ngen=2, gaussian_ngen=3, rng=random.Random(0))
        out.append(search.run())
    assert out[0] == out[1]
    assert sum(v[0] for v in out[0][0].values()) <= 30.0 + 1e-6


def _tsv(path, rng, n=300):
    rows = []
    for i in range(n):
        preds = rng.uniform(0, 1, 4)
        cols = [str(i), "x", "y"] + ["%.6f" % v for v in preds] + [
            "%.4f" % rng.uniform(0, 1), "%.3f" % rng.uniform(0, 60),
            str(int(rng.integers(0, 3))), "0", str(int(rng.integers(0, 2))),
            str(int(rng.integers(0, 2)))]
        if i % 17 == 0:
            cols[5] = "\\N"                           # skipped rows
        if i % 23 == 0:
            cols[9] = "-1"
        rows.append("\t".join(cols))
    path.write_text("\n".join(rows) + "\n")


def test_reader_matches_jax(tmp_path):
    path = tmp_path / "log.tsv"
    _tsv(path, np.random.default_rng(5))
    got = S.Reader(str(path)).parse_lines(sample_rate=1.1)
    want = J.Reader(str(path)).parse_lines(sample_rate=1.1)
    assert got == want and 250 < len(got) < 300
    got = S.Reader(str(path)).parseLines(sample_rate=0.3, rng=random.Random(2))
    assert got == J.Reader(str(path)).parseLines(sample_rate=0.3, rng=random.Random(2))


def _run(main, argv, monkeypatch):
    """stdout of a CLI run with every unseeded ``random.Random()`` seeded 0,
    less the reader's timing."""
    seeded = random.Random
    monkeypatch.setattr(random, "Random", lambda *a: seeded(*(a or (0,))))
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv)
    monkeypatch.setattr(random, "Random", seeded)
    return [line for line in buf.getvalue().splitlines() if not line.startswith("parsed ")]


def test_pso_cli_matches_jax(tmp_path, monkeypatch):
    path = tmp_path / "log.tsv"
    _tsv(path, np.random.default_rng(6))
    argv = ["pso", str(path), "2", "6", "--sample-rate", "1.1"]
    got = _run(cli.main, argv, monkeypatch)
    assert got == _run(jax_cli.main, argv, monkeypatch)
    assert any(line.startswith("best fitness:") for line in got)


def test_gp_cli_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    n, users = 900, 30
    cols = {"user_id": rng.integers(0, users, n),
            "is_coin_user": rng.integers(0, 2, n)}
    quality = rng.uniform(size=n)
    for h in S.default_bound_x():
        s = np.clip(quality * 0.5 + rng.uniform(0, 0.5, n), 1e-4, 1)
        cols[f"{h}_score"] = s
        cols[f"{h}_label"] = (quality * 100 + rng.normal(0, 10, n) if h == "staytime"
                              else (rng.uniform(size=n) < s).astype(float))
    path = tmp_path / "dump.csv"
    header = list(cols)
    lines = [",".join(header)] + [",".join(repr(float(cols[c][i])) if "score" in c or
                                           "label" in c else str(int(cols[c][i]))
                                           for c in header) for i in range(n)]
    path.write_text("\n".join(lines) + "\n")
    argv = ["gp", str(path), "--popsize", "3", "--ngen", "1", "--gaussian-ngen", "2",
            "--buckets", "2"]
    got = _run(cli.main, argv, monkeypatch)
    assert got == _run(jax_cli.main, argv, monkeypatch)
    assert sum("Best Result" in line for line in got) == 3     # all, coin, non-coin users


def test_cli_runs_as_a_module(tmp_path):
    path = tmp_path / "log.tsv"
    _tsv(path, np.random.default_rng(8), n=60)
    out = subprocess.run([sys.executable, "-m", "recommendsystem_tpu_torch.search.cli", "pso",
                          str(path), "1", "3", "--sample-rate", "1.1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "best fitness:" in out.stdout
