"""The harness's sharded path, four ranks on the CPU (gloo) at the tiny
size, as the four-card cell ``autoint.train.dp4`` runs it
(``traffic/train.zipf.b65536x4.json``): the run agrees with the reference's
steps on the global batch and reports the exchange's drops over the whole
pool, and with the exchange between ranks dropped, or half of each batch
left out, it comes out not correct.  A traced run reports the cell's
per-layer metrics, each rank's K8 share counted from the whole batch's ids
in its blocks of the tables' storages, and the exchange read collective
by collective."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


SEED = 2 ** 31 + 5


def _run(fault=None, world=4):
    port = _port()
    extra = [fault] if fault else []
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "ranks_cpu.py"),
                               "autoint.train.dp4", "train.zipf.b65536x4", str(r), str(world),
                               str(port), str(SEED), *extra],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env={**os.environ, "OMP_NUM_THREADS": "1"})
             for r in range(world)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


def test_sharded_run_is_correct():
    result = _run()
    assert result["correct"] is True, result["checks"]
    assert result["device"]["count"] == 4
    assert result["checks"]["drops"] == {"value": 0.0, "limit": 0.0}
    assert all(c["value"] <= 1e-5 for c in result["checks"].values())


@pytest.mark.parametrize("fault", ["exchange_dropped", "half_batch"])
def test_broken_sharded_path_is_not_correct(fault):
    result = _run(fault)
    assert result["correct"] is False


def test_traced_sharded_run_reads_each_ranks_shard():
    """With the stand-in kernels on every rank's trace (``ranks_cpu.py``):
    K8's share is the mean over the ranks of 100 x a rank's least time,
    counted from the whole batches' ids in its blocks of the tables'
    storages, over its 1 s of K8; the exchange is the sum of each
    collective's least time over the ranks (1 ms each, three a step),
    not the least rank's total (6.5 ms a step); every metric of the cell
    is there."""
    import ranks_cpu
    from conftest import tiny_cell
    from harness import cells
    from harness.peaks import least_seconds
    from harness.traffic import Traffic

    result = _run("traced")
    assert result["correct"] is True, result["checks"]
    got = result["metrics"]
    assert set(got) == {p["name"] for p in cells.load("autoint.train.dp4").per_layer}
    assert all(v["value"] is not None for v in got.values())
    cell = tiny_cell("autoint.train.dp4")
    gen = Traffic(cell.model, cell.m, cell.traffic, SEED, "cpu")
    b = cell.traffic["batch"]
    whole = [{key: {k: torch.cat([p[key][k] for p in parts]) for k in parts[0][key]}
              for key in ("ids", "mask")}
             for parts in ([gen.batch(i, b, r * b) for r in range(4)] for i in range(2))]
    per_rank = [sum(least_seconds(*cell.counts.kernel(cell.m, "sparse_update", w, shard=(r, 4)))
                    for w in whole) for r in range(4)]
    want = 100.0 * sum(per_rank) / 4 / ranks_cpu.ONE_CARD_K8_S
    assert got["sparse_update_roofline.train"]["value"] == pytest.approx(want, rel=1e-9)
    assert got["exchange_ms.train"]["value"] == pytest.approx(
        1e3 * ranks_cpu.NCCL_S * len(ranks_cpu.COLLECTIVES))
    assert got["rank_wait_share.train"]["value"] > 0
    assert got["field_attention_bwd_roofline.train"]["value"] > 0
    assert result["device"]["count"] == 4 and result["device"]["busy_s"] >= 0
