"""``BENCHMARK.json`` keeps the contract's rules, and every name in it
finds its file."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import manifest
from benchmark.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


@pytest.fixture(scope="module")
def m():
    return manifest.load_manifest(REPO)


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys(m):
    assert set(m) == KEYS["top"]
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[sec]:
            assert set(e) <= KEYS[sec], (sec, e["name"])
    assert len(json.dumps(m)) <= 64 * 1024


def test_names_and_units(m):
    names = [e["name"] for sec in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in m[sec]]
    for n in names:
        assert NAME.match(n), n
    for sec in ("configs", "workloads"):
        assert len({e["name"] for e in m[sec]}) == len(m[sec])
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({e["name"] for e in metrics}) == len(metrics)
    for e in metrics:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"])
    for c in m["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not re.search(r"(_dim|_rank|hidden|width|head)", k), k


def test_command_and_paths(m):
    assert 1 <= len(m["paths"]) <= 16 and len(m["command"]) <= 32
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(REPO, p))
    for word in m["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    assert 1 <= m["run_seconds"] <= 51


def test_sizes(m):
    assert 1 <= len(m["configs"]) <= 24
    assert 1 <= len(m["workloads"]) <= 24
    assert 1 <= len(m["end_to_end"]) <= 16
    assert 1 <= len(m["per_layer"]) <= 128
    four = [w for w in m["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in m["workloads"])
    assert len(four) <= max(1, len(m["workloads"]) // 4)


def test_bounds(m):
    names = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in names
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for e in m["per_layer"]:
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(e["layer"])


def test_every_config_has_a_cell(m):
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for c in m["configs"]:
        path = os.path.join(REPO, c["file"])
        assert c["file"].startswith(tuple(p + "/" for p in m["paths"]))
        with open(path) as f:
            assert json.load(f)["name"] == c["name"]


def test_every_cell_reports(m):
    """Each cell reports setup_s, another end-to-end metric and a per-layer
    one, and every per-layer metric's ``moves`` metric in each of its
    cells."""
    for w in m["workloads"]:
        cell = manifest.load_cell(REPO, w["name"], m)
        e2e = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for p in cell.per_layer:
            assert p["moves"] in e2e, (w["name"], p["name"])
    cells = {w["name"] for w in m["workloads"]}
    for p in m["per_layer"]:
        assert p["workloads"] and set(p["workloads"]) <= cells, p["name"]
        for cell in p["workloads"]:
            e2e = {e["name"] for e in m["end_to_end"]
                   if manifest.reports(e, cell)}
            assert p["moves"] in e2e, (p["name"], cell)


def test_files_found_by_name(m):
    for w in m["workloads"]:
        cell = manifest.load_cell(REPO, w["name"], m)
        assert manifest.job_module(cell.job).Job
        assert set(cell.limits), f"{w['name']} has no limits file"
    for p in m["per_layer"]:
        assert callable(manifest.metric_reader(p["name"]))
