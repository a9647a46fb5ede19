"""The port's store, extraction, eval and CLI against the JAX reference, and
the port's guards: no JAX import, no silent CPU fallback.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eov_tpu.data.store import FeatureStore as JStore
from eov_tpu.eval import EvalConfig as JEvalConfig
from eov_tpu.eval import FeatureTable as JTable
from eov_tpu.eval import evaluate as j_evaluate

from eov_tpu_torch.data.datasets import SyntheticVideoDataset
from eov_tpu_torch.data.store import FeatureStore
from eov_tpu_torch.eval import EvalConfig, FeatureTable, evaluate
from eov_tpu_torch.extract import ExtractConfig, extract_features

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _table(c=8, m=5, d=64, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((c, m, d)).astype(np.float32)
    # class structure, so accuracy is neither 0 nor 1
    feats += 0.4 * rng.standard_normal((c, 1, d)).astype(np.float32)
    counts = rng.integers(2, m + 1, c)
    counts[0] = 1  # ineligible for k_shot + n_query >= 2
    for ci, n in enumerate(counts):
        feats[ci, n:] = 0.0
    return feats, counts


@pytest.mark.parametrize("kw", [
    dict(n_way=5, k_shot=1, n_query=1, metric="cosine", fusion="max"),
    dict(n_way=4, k_shot=2, n_query=1, metric="euclidean", fusion="mean"),
    dict(n_way=3, k_shot=1, n_query=2, metric="cosine", fusion="mean"),
])
def test_evaluate_equals_reference(kw):
    feats, counts = _table()
    cfg = dict(n_episodes=150, episodes_per_step=32, seed=5, **kw)
    want = j_evaluate(JTable(jnp.asarray(feats), jnp.asarray(counts,
                                                             jnp.int32)),
                      JEvalConfig(**cfg))
    got = evaluate(FeatureTable(torch.from_numpy(feats),
                                torch.from_numpy(counts)), EvalConfig(**cfg))
    np.testing.assert_array_equal(got.per_episode, want.per_episode)
    assert got.mean_acc == want.mean_acc
    assert str(got) == str(want)
    assert 0.0 < got.mean_acc < 1.0


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_store_interchange_both_ways(tmp_path, dtype):
    rng = np.random.default_rng(3)
    names = ["a", "b", "c"]
    data = {f"v{i:02d}": (rng.standard_normal(16).astype(np.float32), i % 3)
            for i in range(9)}
    ours = FeatureStore(str(tmp_path / "port"), class_names=names,
                        dtype=dtype, quant=None)
    theirs = JStore(str(tmp_path / "ref"), class_names=names,
                    process_index=0, dtype=dtype, quant=None)
    for i, (vid, (f, label)) in enumerate(data.items()):
        for s in (ours, theirs):
            s.put(vid, f, label)
        if i == 4:
            ours.flush()
            theirs.flush()
    ours.flush()
    theirs.flush()
    for src, reader in (("port", lambda r: JStore(r, process_index=0)),
                        ("ref", FeatureStore)):
        store = reader(str(tmp_path / src))
        loaded = store.load_all()
        assert set(loaded) == set(data)
        for vid, (f, label) in data.items():
            np.testing.assert_array_equal(loaded[vid][0],
                                          f.astype(dtype).astype(np.float32))
            assert loaded[vid][1] == label
        assert store.class_names == names
        assert store.recorded_quant() == (None, True)
    a = FeatureStore(str(tmp_path / "port")).to_table("cpu")
    b = JStore(str(tmp_path / "port"), process_index=0).to_table()
    np.testing.assert_array_equal(a.features.numpy(), np.asarray(b.features))
    np.testing.assert_array_equal(a.counts.numpy(), np.asarray(b.counts))
    with pytest.raises(ValueError):  # one dtype per store, as the reference
        FeatureStore(str(tmp_path / "ref"),
                     dtype="float16" if dtype == "float32" else "float32")


def test_extract_skips_faults_and_resumes(tmp_path):
    ds = SyntheticVideoDataset(n_classes=3, clips_per_class=4, height=40,
                               width=48, seed=1)
    store = FeatureStore(str(tmp_path / "s"), class_names=ds.class_names,
                         quant=None)

    def feature_fn(frames):  # cheap featurizer: mean colour per clip
        return frames.float().mean(dim=(1, 2, 3))

    cfg = ExtractConfig(num_segments=4, batch_clips=5, flush_every=4,
                        fault_inject=0.3, fault_seed=2)
    stats = extract_features(ds, None, store, cfg, feature_fn=feature_fn,
                             device="cpu")
    assert stats["failed"] > 0
    assert stats["extracted"] + stats["failed"] == len(ds.records)
    assert len(store.done_ids()) == stats["extracted"]
    again = extract_features(
        ds, None, FeatureStore(str(tmp_path / "s"), quant=None),
        ExtractConfig(num_segments=4, batch_clips=5, deterministic=True),
        feature_fn=feature_fn, device="cpu")
    assert again["skipped_done"] == stats["extracted"]
    assert again["extracted"] == stats["failed"] and again["failed"] == 0
    assert len(FeatureStore(str(tmp_path / "s")).done_ids()) == 12


def test_cli_end_to_end(tmp_path, capsys):
    """extract (python -m), eval, a resuming extract that extracts nothing;
    the port's store then scores the identical episodes in the reference."""
    from eov_tpu_torch import cli

    store = str(tmp_path / "store")
    argv = [sys.executable, "-m", "eov_tpu_torch.cli", "extract",
            "--device", "cpu", "--preset", "synthetic_smoke", "--store",
            store, "--synthetic-classes", "4", "--synthetic-clips", "3",
            "--synthetic-height", "72", "--synthetic-width", "80",
            "--scale-size", "72", "--crop-size", "64"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(argv, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1])["extracted"] == 12
    assert "RANDOM" in out.stderr

    per_ep = str(tmp_path / "per_episode.json")
    assert cli.main(["eval", "--device", "cpu", "--preset", "synthetic_smoke",
                     "--store", store, "--per-episode-out", per_ep]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("accuracy: ") and last.endswith("%")

    again = subprocess.run(argv, capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=300)
    assert again.returncode == 0, again.stderr
    assert json.loads(again.stdout.strip().splitlines()[-1])["extracted"] == 0

    with open(per_ep) as f:
        doc = json.load(f)
    ref = j_evaluate(JStore(store, process_index=0).to_table(),
                     JEvalConfig(n_way=3, k_shot=1, n_query=2, n_episodes=30,
                                 episodes_per_step=10))
    np.testing.assert_array_equal(np.asarray(doc["per_episode"], np.float32),
                                  ref.per_episode)


def test_package_imports_no_jax():
    """Every eov_tpu_torch module (and chip_smoke.py, bench_torch.py)
    imports with jax blocked, and no source names the reference package in
    an import."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import eov_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "eov_tpu_torch.__path__, 'eov_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke, bench_torch\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        "and (m == 'eov_tpu' or m.startswith(('eov_tpu.', 'jax', 'flax')))]\n"
        "assert not bad, bad\n"
        "new = {'eov_tpu_torch.runtime.eovc', 'eov_tpu_torch.runtime.native', "
        "'eov_tpu_torch.data.class_splits', 'eov_tpu_torch.data.datasets', "
        "'eov_tpu_torch.tools.pack_eovc', 'eov_tpu_torch.bench.features', "
        "'eov_tpu_torch.bench.train', 'eov_tpu_torch.bench.eval', "
        "'eov_tpu_torch.bench.e2e', 'eov_tpu_torch.utils.flops', "
        "'eov_tpu_torch.utils.trace', 'eov_tpu_torch.tools.profile_summary', "
        "'eov_tpu_torch.tools.compare_eval', "
        "'eov_tpu_torch.bench.fused_eval', 'eov_tpu_torch.bench.classify', "
        "'eov_tpu_torch.bench.episode', 'eov_tpu_torch.bench.decode', "
        "'eov_tpu_torch.tools.make_splits', "
        "'eov_tpu_torch.tools.extract_frames', "
        "'eov_tpu_torch.tools.export_features', "
        "'eov_tpu_torch.tools.import_features', "
        "'eov_tpu_torch.parallel', 'eov_tpu_torch.parallel.mesh', "
        "'eov_tpu_torch.parallel.distributed', "
        "'eov_tpu_torch.parallel.sharded', 'eov_tpu_torch.tools.torch_ref', "
        "'eov_tpu_torch.tools.parity_harness'}\n"
        "assert new <= set(mods), new - set(mods)\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 63
    import re

    pat = re.compile(r"^\s*(from|import)\s+(eov_tpu|jax|flax)(\.|\s|$)",
                     re.M)
    paths = [os.path.join(ROOT, f) for f in ("chip_smoke.py",
                                              "bench_torch.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "eov_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def test_no_silent_cpu_fallback(tmp_path):
    """Without a GPU, the default-device entry points raise instead of
    running on the CPU, and so does a kernel build."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from eov_tpu_torch import cli
    from eov_tpu_torch.extract import make_feature_fn
    from eov_tpu_torch.models.resnet import random_state_dict
    from eov_tpu_torch.ops import _cuda

    ds = SyntheticVideoDataset(n_classes=2, clips_per_class=2, height=40,
                               width=48)
    store = FeatureStore(str(tmp_path / "s"), class_names=ds.class_names)
    weights = random_state_dict("resnet18", width=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_features(ds, weights, store, ExtractConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        make_feature_fn(weights, ExtractConfig(arch="resnet18"))
    store.put("x", np.zeros(4, np.float32), 0)
    store.flush()
    with pytest.raises(RuntimeError, match="CUDA"):
        store.to_table()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["eval", "--store", str(tmp_path / "s")])
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            _cuda.build(("crop_normalize",))
