"""A later PR adds a configuration, a traffic mix, a cell and a per-layer
metric by adding files and manifest entries: the harness finds them by
name, and no file that was there changes."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import pytest

from benchmark import manifest
from benchmark.tests.conftest import REPO


def _digests(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if f.endswith((".py", ".json")):
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_add_by_files(tmp_path, monkeypatch):
    root = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    before = _digests(root)
    b = os.path.join(root, "benchmark")
    # a configuration
    with open(os.path.join(b, "configs", "resnet50_tsn.json")) as f:
        cfg = json.load(f)
    cfg.update(name="resnet101_tsn", arch="resnet101",
               stage_sizes=[3, 4, 23, 3])
    with open(os.path.join(b, "configs", "resnet101_tsn.json"), "w") as f:
        json.dump(cfg, f)
    # a traffic mix
    with open(os.path.join(b, "traffic", "tsn_extract.json")) as f:
        tr = json.load(f)
    tr["batch_clips"] = 64
    with open(os.path.join(b, "traffic", "tsn_extract_b64.json"), "w") as f:
        json.dump(tr, f)
    # the cell's limits and a per-layer metric's reader
    with open(os.path.join(b, "limits", "r101_extract.json"), "w") as f:
        json.dump({"feature_gap": 0.1, "missing_clips": 0}, f)
    with open(os.path.join(b, "metrics", "store_share.extract.py"),
              "w") as f:
        f.write("def read(run):\n    return 42.0\n")
    m = manifest.load_manifest(root)
    m["configs"].append({"name": "resnet101_tsn", "source": "x",
                         "file": "benchmark/configs/resnet101_tsn.json",
                         "reduced": [], "why": "deeper"})
    m["workloads"].append({"name": "r101_extract", "config": "resnet101_tsn",
                           "traffic": "tsn_extract_b64", "chips": 1,
                           "why": "deeper"})
    m["end_to_end"][2]["workloads"].append("r101_extract")
    m["per_layer"].append({"name": "store_share.extract", "unit": "%",
                           "better": "lower", "source": "program_span",
                           "layer": "extraction loop",
                           "moves": "extract_clips_per_s",
                           "workloads": ["r101_extract"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)

    monkeypatch.setattr(manifest, "HERE", b)
    cell = manifest.load_cell(root, "r101_extract")
    assert cell.config["arch"] == "resnet101"
    assert cell.traffic["batch_clips"] == 64 and cell.job == "extract"
    assert cell.limits == {"feature_gap": 0.1, "missing_clips": 0}
    assert {e["name"] for e in cell.end_to_end} == {"setup_s",
                                                    "extract_clips_per_s"}
    assert "store_share.extract" in {p["name"] for p in cell.per_layer}
    assert manifest.metric_reader("store_share.extract")(None) == 42.0
    # the new metric is read in the cells it lists and no other
    old = manifest.load_cell(root, "r50_extract")
    assert "store_share.extract" not in {p["name"] for p in old.per_layer}
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_per_layer_lists_its_cells(tmp_path):
    """A per-layer metric without ``workloads`` is refused: what it reports
    never follows from another entry."""
    m = manifest.load_manifest(REPO)
    m["per_layer"][0] = {k: v for k, v in m["per_layer"][0].items()
                         if k != "workloads"}
    with open(os.path.join(tmp_path, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    with pytest.raises(SystemExit, match="without workloads"):
        manifest.load_cell(str(tmp_path), "r50_extract")
