"""No module of the benchmark imports JAX or the JAX package, and the
reference and the frozen copies import nothing of the program: top-level
module names compared whole (``eov_tpu_torch`` is not ``eov_tpu``)."""

from __future__ import annotations

import ast
import glob
import os

import pytest

from benchmark.tests.conftest import REPO

BENCH = os.path.join(REPO, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "eov_tpu"}


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__":
            names.add("__import__")
    return names


def _files(sub: str = "") -> list[str]:
    return sorted(glob.glob(os.path.join(BENCH, sub, "**", "*.py"),
                            recursive=True))


@pytest.mark.parametrize("path", _files(), ids=lambda p: os.path.relpath(
    p, BENCH))
def test_no_jax(path):
    assert not _imports(path) & FORBIDDEN
    assert "__import__" not in _imports(path)


@pytest.mark.parametrize("path", _files("reference") + _files("frozen"),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_no_program(path):
    assert "eov_tpu_torch" not in _imports(path)


def test_whole_name_compare():
    """The check tells the port from the JAX package by the whole name."""
    from benchmark.run import FORBIDDEN as RUN_FORBIDDEN

    assert "eov_tpu_torch".split(".")[0] not in RUN_FORBIDDEN
    assert "eov_tpu.extract".split(".")[0] in RUN_FORBIDDEN


def test_run_refuses_loaded_jax(monkeypatch):
    import sys
    import types

    from benchmark import run

    monkeypatch.setitem(sys.modules, "eov_tpu_torch.fake", types.ModuleType(
        "eov_tpu_torch.fake"))
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "eov_tpu.fake",
                        types.ModuleType("eov_tpu.fake"))
    assert run.forbidden_loaded() == ["eov_tpu"]


def _fake_chips(monkeypatch, n):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_every_rank_refuses_loaded_jax(monkeypatch, capsys, rank):
    """A rank that finds the JAX package loaded after its window exits
    non-zero and prints no result, rank 0 or not."""
    import sys
    import types

    from benchmark import run

    _fake_chips(monkeypatch, 4)

    def cell_run(*a, **kw):
        sys.modules["eov_tpu.fake"] = types.ModuleType("eov_tpu.fake")
        return None if kw["rank"] else {"correct": True, "checks": {}}
    monkeypatch.setattr(run, "run_cell", cell_run)
    monkeypatch.delitem(sys.modules, "eov_tpu.fake", raising=False)
    try:
        code = run.main(["--workload", "r50_finetune_dp4", "--seed", "1",
                         "--seconds", "1", "--rank", str(rank), "--world",
                         "4"])
    finally:
        sys.modules.pop("eov_tpu.fake", None)
    assert code != 0
    assert capsys.readouterr().out == ""


def test_launcher_prints_nothing_if_a_rank_fails(monkeypatch, capsys,
                                                 tmp_path):
    """The four-chip launcher prints no result when any rank exits
    non-zero, as a rank that found the JAX package does."""
    import json

    from benchmark import manifest, run

    cell = manifest.load_cell(REPO, "r50_finetune_dp4")
    codes = iter([0, 1, 0, 0])

    class Rank:
        def __init__(self, argv, stdout, stderr, cwd):
            self.returncode = next(codes)
            if self.returncode == 0:
                stdout.write(json.dumps({"correct": True}) + "\n")
                stdout.flush()

        def poll(self):
            return self.returncode

        def wait(self):
            return self.returncode

        def kill(self):
            pass

    monkeypatch.setattr(run.subprocess, "Popen", Rank)
    args = run.argparse.Namespace(workload=cell.name, seed=1, seconds=1,
                                  trace=0)
    assert run._spawn(args, cell, str(tmp_path)) == 1
    assert capsys.readouterr().out == ""
