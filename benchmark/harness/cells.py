"""A cell and everything the harness finds for it by name.

- the cell: its entry in ``BENCHMARK.json`` (configuration, traffic,
  chips);
- ``configs/<config>.json``: the configuration as it is run (the
  program's factory and arguments, the published sizes under ``model``,
  the weights' rule under ``init``);
- ``traffic/<traffic>.json``: the mix (the entry, the batch a rank, the
  pool, the ids and lengths);
- ``reference/<config.reference>.py``: the plain reference;
- ``counts/<config.counts>.py``: the step's FLOPs and bytes and the
  kernels' counts;
- ``metrics/<metric>.py``: one reader a per-layer metric;
- ``limits/<cell>.json``: the limit of each number ``correct`` compares.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import Dict, List

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_file(path: str, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def m(self) -> dict:
        return self.cfg["model"]

    @property
    def model(self):
        return importlib.import_module(f"reference.{self.cfg['reference']}")

    @property
    def counts(self):
        return importlib.import_module(f"counts.{self.cfg['counts']}")

    def limits(self) -> Dict[str, float]:
        data = _json(BENCH, "limits", f"{self.name}.json")
        return {k: float(v["limit"]) for k, v in data["numbers"].items()}

    def reader(self, metric: str):
        return load_file(os.path.join(BENCH, "metrics", f"{metric}.py"),
                         "bench_metric_" + metric.replace(".", "_"))


def load(name: str, manifest: str = os.path.join(ROOT, "BENCHMARK.json")) -> Cell:
    with open(manifest) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {manifest}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _json(ROOT, configs[w["config"]]["file"])
    traffic = _json(BENCH, "traffic", f"{w['traffic']}.json")
    e2e = [e for e in bench["end_to_end"] if name in e.get("workloads", [name])]
    reported = {e["name"] for e in e2e}
    per_layer = [p for p in bench["per_layer"] if p["moves"] in reported
                 and name in p.get("workloads", [name])]
    return Cell(name=name, chips=int(w["chips"]), cfg=cfg, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer)
