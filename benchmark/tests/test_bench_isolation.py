"""The reference and the harness's own parts load nothing of JAX, of the
JAX package or of the program; the look for JAX modules compares whole
top-level names (the program's name begins with the JAX package's)."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import BENCH, ROOT

LOAD = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import reference.common, reference.driver, reference.autoint, reference.staytime
import harness.traffic, harness.peaks, harness.compare, harness.trace, harness.cells
import counts.autoint, counts.staytime
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def test_reference_and_harness_load_no_program_and_no_jax():
    out = subprocess.run([sys.executable, "-c", LOAD.format(bench=BENCH, root=ROOT)],
                         capture_output=True, text=True, check=True, cwd=ROOT).stdout
    tops = set(json.loads(out.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "optax", "orbax", "recommendsystem_tpu",
                       "recommendsystem_tpu_torch"}


def test_the_look_for_jax_compares_whole_names(monkeypatch):
    from harness import runner

    for name in ("recommendsystem_tpu_torch", "recommendsystem_tpu_torch.train",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys.modules[__name__])
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "recommendsystem_tpu.models", sys.modules[__name__])
    monkeypatch.setitem(sys.modules, "jax", sys.modules[__name__])
    assert runner.forbidden_modules() == ["jax", "recommendsystem_tpu.models"]


def test_the_reference_reads_no_file_of_the_jax_benchmark():
    import pathlib

    for path in pathlib.Path(BENCH).rglob("*.py"):
        text = path.read_text()
        for word in ("bench.py", "BENCH_r", "MULTICHIP_"):
            assert word not in text or path.name in ("test_bench_isolation.py",), (path, word)
