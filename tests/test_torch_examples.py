"""The port's examples (``examples/torch_train_ctr.py``,
``examples/torch_train_staytime_gauc.py``) run end to end on the CPU in a
subprocess at a small size (a few steps, B 64, 1,024-id buckets): the ctr
and autoint trainers print each task's metrics, the staytime trainer the
three GAUCs, also under bf16 tables and the bf16 compute policy; without
``--device cpu`` they ask for the card, which a machine with no CUDA
refuses."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--steps", "3", "--batch-size", "64", "--bucket-size", "1024"]


def _run(script, *args, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(ROOT / "examples" / script), *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("model", ["ctr", "autoint"])
def test_train_ctr_example_on_the_cpu(model):
    out = _run("torch_train_ctr.py", "--model", model, *SMALL, "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [l for l in out.stdout.splitlines() if "'auc'" in l]
    assert len(lines) == (2 if model == "ctr" else 1), out.stdout
    for line in lines:
        assert "'acc'" in line and "'copc'" in line and "nan" not in line, line


@pytest.mark.parametrize("dtypes", [(), ("--table-dtype", "bf16", "--compute-dtype", "bf16")],
                         ids=["fp32", "bf16"])
def test_train_staytime_gauc_example_on_the_cpu(dtypes):
    out = _run("torch_train_staytime_gauc.py", *SMALL, "--seq-max-len", "8",
               "--device", "cpu", *dtypes)
    assert out.returncode == 0, out.stderr[-3000:]
    gaucs = [l for l in out.stdout.splitlines() if l.startswith("GAUC[")]
    assert len(gaucs) == 3, out.stdout
    for line in gaucs:
        assert 0.0 <= float(line.rsplit("=", 1)[1]) <= 1.0, line


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="a card is present")
def test_examples_default_to_the_card():
    for script in ("torch_train_ctr.py", "torch_train_staytime_gauc.py"):
        out = _run(script, *SMALL)
        assert out.returncode != 0 and "CUDA" in out.stderr, out.stderr[-2000:]
    # no --bf16: the port spells it --compute-dtype bf16
    out = _run("torch_train_staytime_gauc.py", "--bf16", "--device", "cpu")
    assert out.returncode == 2 and "--bf16" in out.stderr
