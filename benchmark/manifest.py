"""``BENCHMARK.json`` and the files it names, found by name.

A cell is an entry of ``workloads``; its configuration is the file its
``config`` entry names; its traffic is ``benchmark/traffic/<traffic>.json``,
which names the job (``benchmark/jobs/<job>.py``) and holds its
parameters; the limits of what decides ``correct`` are
``benchmark/limits/<cell>.json``; a per-layer metric's reader is
``benchmark/metrics/<name>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # the manifest's end-to-end entries this cell reports
    per_layer: list       # and its per-layer entries
    limits: dict          # what ``correct`` compares -> its limit

    @property
    def job(self) -> str:
        return self.traffic["job"]


def load_manifest(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def reports(entry: dict, cell: str) -> bool:
    """Does ``cell`` report this metric: the cells its ``workloads`` list;
    an end-to-end metric without the key, every cell. A per-layer metric
    lists its cells always (``load_cell`` refuses one that does not)."""
    return cell in entry.get("workloads", (cell,))


def load_cell(root: str, name: str, manifest: dict | None = None) -> Cell:
    m = manifest or load_manifest(root)
    unlisted = [p["name"] for p in m["per_layer"] if "workloads" not in p]
    if unlisted:
        raise SystemExit(f"per-layer metrics without workloads: {unlisted}")
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in m["configs"] if c["name"] == entry["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{entry['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [e for e in m["end_to_end"] if reports(e, name)]
    per_layer = [p for p in m["per_layer"] if reports(p, name)]
    limits_file = os.path.join(HERE, "limits", f"{name}.json")
    limits = {}
    if os.path.exists(limits_file):
        with open(limits_file) as f:
            limits = json.load(f)
    return Cell(name, int(entry["chips"]), config, traffic, e2e, per_layer,
                limits)


def _load_file(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def job_module(job: str):
    return _load_file(os.path.join(HERE, "jobs", f"{job}.py"),
                      f"benchmark.jobs.{job}")


def metric_reader(name: str):
    """The ``read(run)`` of ``benchmark/metrics/<name>.py``."""
    return _load_file(os.path.join(HERE, "metrics", f"{name}.py"),
                      f"benchmark.metrics.{name.replace('.', '_')}").read
