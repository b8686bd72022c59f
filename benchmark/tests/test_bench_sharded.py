"""The harness's sharded path, four ranks on the CPU (gloo) at the tiny
size, under the four-card mix kept for a later cell
(``traffic/train.zipf.b65536x4.json``): the run agrees with one local
reference step on the global batch and reports the exchange's drops over
the whole pool, and with the exchange between ranks dropped, or half of
each batch left out, it comes out not correct."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(fault=None, world=4):
    port = _port()
    extra = [fault] if fault else []
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "ranks_cpu.py"),
                               "autoint.train", "train.zipf.b65536x4", str(r), str(world),
                               str(port), str(2 ** 31 + 5), *extra],
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
