"""``BENCHMARK.json`` against the benchmark contract's rules: its keys, the
character rules of names and units, the files each entry names, the
metrics each cell reports, the share of four-chip cells and the chip time
of a full check."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.endswith("_torch")
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    files = [w for w in cmd if os.path.exists(os.path.join(ROOT, w))]
    assert all(any(f.startswith(p + "/") for p in bench["paths"]) for f in files)


def test_run_seconds_fits_a_full_check(bench):
    r = bench["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    cells = 24
    assert (2 + 14 * cells) * (r + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    assert 1 <= len(bench["configs"]) <= 24
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        for mod in ("reference", "counts"):
            assert os.path.exists(os.path.join(BENCH, mod, f"{cfg[mod]}.py"))


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    assert 1 <= len(bench["workloads"]) <= 24
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        with open(os.path.join(BENCH, "traffic", f"{w['traffic']}.json")) as f:
            traffic = json.load(f)
        assert traffic.get("ranks", 1) == w["chips"]
        with open(os.path.join(BENCH, "limits", f"{w['name']}.json")) as f:
            limits = json.load(f)["numbers"]
        assert limits and all(v["limit"] > 0 for v in limits.values())
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {e["name"]: e for e in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for e in bench["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        assert set(e.get("workloads", cells)) <= cells
    layers = {}
    for p in bench["per_layer"]:
        assert set(p) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(p["unit"]) and p["better"] in ("lower", "higher")
        assert p["source"] in SOURCES and _line(p["layer"])
        assert p["moves"] in e2e and p["moves"] != "setup_s"
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{p['name']}.py"))
        reporting = set(e2e[p["moves"]].get("workloads", cells))
        assert set(p["workloads"]) <= reporting
        layers.setdefault(p["layer"].lower(), set()).add(p["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        reported = [e for e in bench["end_to_end"] if cell in e.get("workloads", cells)]
        assert any(e["name"] == "setup_s" for e in reported) and len(reported) >= 2
        assert any(cell in p["workloads"] for p in bench["per_layer"])
