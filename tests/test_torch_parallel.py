"""Multi-GPU extraction, eval and the helpers of the port on the CPU: a
group of two gloo ranks (``torch_multirank_worker.py pipeline``) against
the port's single-process programs and the reference's sharded ones
(``make_sharded_feature_fn`` / ``evaluate_sharded`` on ``make_mesh(2,
1)`` over the virtual CPU devices); the refusals; and the CLI under
``torchrun`` (``python -m torch.distributed.run``).

Fixtures: 4 classes x 3 synthetic clips at 32x40, resnet18 with seeded
weights, K 2, crop 32, f32, 4 clips a global step. One group runs every
multi-rank case (about 6 s); the file takes about 31 s serial, most of it
the reference's compiles and the torchrun launch.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_multirank_worker as W
from torch_flax_variables import to_flax_variables

from eov_tpu.data.store import FeatureStore as JFeatureStore
from eov_tpu.eval import EvalConfig as JEvalConfig
from eov_tpu.eval import FeatureTable as JFeatureTable
from eov_tpu.eval import evaluate as j_evaluate
from eov_tpu.parallel.mesh import make_mesh as j_make_mesh
from eov_tpu.parallel.sharded import evaluate_sharded as j_evaluate_sharded
from eov_tpu.parallel.sharded import (make_sharded_feature_fn as
                                      j_make_sharded_feature_fn)

from eov_tpu_torch import cli
from eov_tpu_torch.data.segments import center_indices_np
from eov_tpu_torch.data.store import FeatureStore, MemoryFeatureStore
from eov_tpu_torch.eval import EvalConfig, evaluate
from eov_tpu_torch.extract import ExtractConfig, extract_features
from eov_tpu_torch.models.resnet import random_state_dict
from eov_tpu_torch.parallel import distributed as pdist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs several test
    workers on one machine, and each ResNet forward here would otherwise
    spin a thread per core against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pipeline_group"))
    return out, W.launch("pipeline", out)


@pytest.fixture(scope="module")
def weights():
    return random_state_dict("resnet18", seed=0)


def _single(weights, act_max=None, **kw) -> dict:
    """The port's single-process extraction of the fixture dataset."""
    ds = W.dataset()
    store = MemoryFeatureStore(class_names=list(ds.class_names))
    extract_features(ds, weights, store, ExtractConfig(**{**W.EXTRACT, **kw}),
                     device="cpu", act_max=act_max)
    return store.load_all()


def _merged(out, name) -> dict:
    return FeatureStore(os.path.join(out, name)).load_all()


def _same_clips(got: dict, want: dict, rtol=1e-5, atol=1e-6):
    assert set(got) == set(want)
    for vid in want:
        assert got[vid][1] == want[vid][1], vid
        np.testing.assert_allclose(got[vid][0], want[vid][0], rtol=rtol,
                                   atol=atol, err_msg=vid)


def _cosine(a, b):
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(
        b, axis=-1)


def _reference_features(weights, **kw) -> dict:
    """The reference's sharded featurizer on make_mesh(2, 1) over every
    clip of the fixture."""
    ds = W.dataset()
    clips = np.stack([ds.get_frames(r, center_indices_np(r.num_frames, 2))
                      for r in ds.records])
    fn = j_make_sharded_feature_fn(
        to_flax_variables(weights), j_make_mesh(2, 1), scale_size=32,
        crop_size=32, compute_dtype=jnp.float32, arch="resnet18", **kw)
    feats = np.asarray(fn(jnp.asarray(clips)))
    return {r.video_id: feats[i] for i, r in enumerate(ds.records)}


# ----------------------------------------------------------------- helpers

def test_helpers(group):
    """global_max over the ranks; the record shard strides by the data
    index (frame ranks of a row share it); meshes that do not divide the
    world are refused."""
    _, ranks = group
    assert [r["global_max"] for r in ranks] == [8, 8]
    assert [r["mesh"] for r in ranks] == [[(0, 0), (0, 0)], [(1, 0), (0, 1)]]
    assert ranks[0]["shard_data"] == [0, 2, 4, 6]
    assert ranks[1]["shard_data"] == [1, 3, 5]
    assert ranks[0]["shard_frame"] == ranks[1]["shard_frame"] == list(
        range(7))
    for r in ranks:
        assert "not divisible by n_frame=3" in r["bad_frame"]
        assert "needs 4 ranks" in r["bad_size"]


def test_refusals_without_a_group(tmp_path):
    """NCCL asked for on a machine with no GPU raises and names gloo; a
    rank outside the world raises; without a launcher or arguments
    nothing is initialized (a world of one)."""
    init = "file://" + str(tmp_path / "init")
    with pytest.raises(ValueError, match='backend="gloo"'):
        pdist.initialize("nccl", init_method=init, world_size=1, rank=0)
    with pytest.raises(ValueError, match="outside a world of 2"):
        pdist.initialize("gloo", init_method=init, world_size=2, rank=2)
    assert not torch.distributed.is_initialized()
    assert pdist.global_max(5) == 5 and pdist.world_size() == 1
    mesh = pdist.global_mesh()
    assert (mesh.n_data, mesh.n_frame, mesh.size) == (1, 1, 1)
    with pytest.raises(ValueError, match="not divisible by n_frame=2"):
        pdist.global_mesh(n_frame=2)


def test_collectives_stage_where_the_backend_takes_them(monkeypatch):
    """gloo runs every collective on the host and NCCL on the rank's GPU,
    so a host tensor (global_max's step count, the extraction's clip mask)
    moves to the GPU under NCCL; every collective stages its tensor there
    first. The group of two is faked: each collective records the
    buffer it was handed."""
    cpu = torch.zeros(2, dtype=torch.int32)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    for backend, want in (("gloo", "cpu"), ("nccl", "cuda:1"),
                          ("mpi", "cpu")):
        monkeypatch.setattr(torch.distributed, "get_backend",
                            lambda group=None, b=backend: b)
        assert pdist.collective_device(cpu) == torch.device(want), backend

    staged, handed = [], []

    def stage(t, group=None):
        staged.append(t.device)
        return torch.device("cpu")

    def record(buf, *args, **kw):
        handed.append(buf)

    def gather(parts, buf, group=None):
        handed.append(buf)
        for p in parts:
            p.copy_(buf)

    monkeypatch.setattr(pdist, "collective_device", stage)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size",
                        lambda group=None: 2)
    monkeypatch.setattr(torch.distributed, "all_reduce", record)
    monkeypatch.setattr(torch.distributed, "broadcast", record)
    monkeypatch.setattr(torch.distributed, "all_gather", gather)
    assert pdist.global_max(7) == 7
    assert pdist.all_reduce(cpu, op="min").tolist() == [0, 0]
    assert pdist.all_gather(cpu).shape == (4,)
    pdist.broadcast_tensors([cpu])
    assert staged == [torch.device("cpu")] * 4 and len(handed) == 4


# -------------------------------------------------------------- extraction

def test_data2_extraction_matches_single_process(group, weights):
    """Two data ranks write one store: the merged clip set and labels are
    the dataset's, each rank extracted its 6 clips, and the features equal
    the single-process extraction (rtol 1e-5; each rank runs the same
    program on 2 of the single process's 4 clips a step)."""
    out, ranks = group
    assert [r["stats_d2"]["extracted"] for r in ranks] == [6, 6]
    _same_clips(_merged(out, "d2"), _single(weights))


def test_data2_extraction_matches_reference(group, weights):
    """The merged store against the reference's make_sharded_feature_fn on
    make_mesh(2, 1) at the f32 per-clip bar of the port's feature-program
    tests: cosine >= 0.99999, rtol 2e-4 / atol 2e-5."""
    out, _ = group
    got = _merged(out, "d2")
    want = _reference_features(weights)
    for vid, (f, _) in got.items():
        assert _cosine(f, want[vid]) >= 0.99999, vid
        np.testing.assert_allclose(f, want[vid], rtol=2e-4, atol=2e-5)


def test_frame2_extraction_matches_single_process(group, weights):
    """Data 1 x frame 2: each rank runs one of the 2 segments, the segment
    sums meet in one all-reduce; rank 0 alone writes, and the features
    equal the single-process mean (rtol 1e-5)."""
    out, ranks = group
    assert [r["stats_f2"]["extracted"] for r in ranks] == [12, 12]
    assert os.path.exists(os.path.join(out, "f2", "manifest.json"))
    assert not os.path.exists(os.path.join(out, "f2", "manifest.p1.json"))
    _same_clips(_merged(out, "f2"), _single(weights))


def test_int8_extraction_with_broadcast_scales(group, weights):
    """int8 with rank 1 handing in other scales: both ranks quantize with
    rank 0's (broadcast), the store equals the single-process int8
    extraction with those scales (rtol 1e-5) and the reference's sharded
    int8 featurizer with the same scales (cosine >= 0.99999)."""
    out, ranks = group
    act = ranks[0]["act_max"]
    assert ranks[1]["act_max"] == act
    got = _merged(out, "i8")
    assert FeatureStore(os.path.join(out, "i8")).recorded_quant() == (
        "int8", True)
    _same_clips(got, _single(weights, quant="int8", act_max=act))
    want = _reference_features(weights, quant="int8", act_max=act)
    for vid, (f, _) in got.items():
        assert _cosine(f, want[vid]) >= 0.99999, vid


def test_unbalanced_ranks_and_resume(group, weights):
    """Rank 0 holds 5 records and rank 1 two, each with a prefix already
    in the store: the second run skips the stored clips, rank 1 pads its
    missing steps, nothing deadlocks, and every clip is in the store
    exactly once, equal to the single-process features."""
    out, ranks = group
    stats = [dict(r["stats_ub_all"]) for r in ranks[:2]]
    for st in stats:  # each rank's pass: its steps, padded ones included
        assert st.pop("report")["steps"] == 3
    assert stats[0] == {"total": 5, "skipped_done": 2, "extracted": 3,
                        "failed": 0}
    assert stats[1] == {"total": 2, "skipped_done": 1, "extracted": 1,
                        "failed": 0}
    seen = []
    for m in ("manifest.json", "manifest.p1.json"):
        with open(os.path.join(out, "ub", m)) as f:
            seen += list(json.load(f)["videos"])
    assert len(seen) == len(set(seen)) == 7
    want = _single(weights)
    got = _merged(out, "ub")
    assert set(got) == {r.video_id for r in W.dataset().records[:7]}
    _same_clips(got, {k: want[k] for k in got})


# -------------------------------------------------------------------- eval

@pytest.mark.parametrize("name", ["plain", "embodied"])
def test_sharded_eval_bit_equal(group, name):
    """per_episode of the 2-rank eval (7 episodes a step rounded to 6)
    equals, bit for bit, the port's single-process evaluate (64 a step)
    and the reference's evaluate_sharded on make_mesh(2, 1)."""
    out, ranks = group
    kw = W.EVAL_PLAIN if name == "plain" else W.EVAL_EMBODIED
    got = ranks[0][f"eval_{name}"]
    np.testing.assert_array_equal(ranks[1][f"eval_{name}"], got)
    table = FeatureStore(os.path.join(out, "d2")).to_table("cpu")
    virt = W.virtual_bank(table.features.shape[-1])
    ours = evaluate(table, EvalConfig(**{**kw, "episodes_per_step": 64}),
                    virtual=virt if name == "embodied" else None)
    np.testing.assert_array_equal(got, ours.per_episode)
    jt = JFeatureTable(jnp.asarray(table.features.numpy()),
                       jnp.asarray(table.counts.numpy().astype(np.int32)))
    jv = JFeatureTable(jnp.asarray(virt.features.numpy()),
                       jnp.asarray(virt.counts.numpy().astype(np.int32)))
    ref = j_evaluate_sharded(jt, JEvalConfig(**kw), j_make_mesh(2, 1),
                             virtual=jv if name == "embodied" else None)
    np.testing.assert_array_equal(got, np.asarray(ref.per_episode))


# --------------------------------------------------------------------- CLI

_CLIPS = ["--device", "cpu", "--preset", "synthetic_smoke", "--arch",
          "resnet18", "--synthetic-classes", "4", "--synthetic-clips", "3",
          "--synthetic-height", "40", "--synthetic-width", "48",
          "--scale-size", "40", "--crop-size", "32"]


def _no_launcher(monkeypatch):
    for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK", "EOV_MULTIHOST"):
        monkeypatch.delenv(v, raising=False)


def test_torchrun_extract_store(tmp_path, monkeypatch, capsys):
    """torchrun with 2 CPU ranks: ``extract --multichip`` writes one store
    (a manifest per data row) whose clips equal a store written without
    --multichip, and which the reference's eval loads: its per-episode
    accuracies equal the port's eval of the single-process store. The
    reverse: a store of two reference writers loads in the port's eval
    with the reference's accuracies."""
    multi, single = str(tmp_path / "multi"), str(tmp_path / "single")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "eov_tpu_torch.cli", "extract",
         "--multichip", *_CLIPS, "--store", multi],
        env=env, capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    stats = [json_line for json_line in run.stdout.splitlines()
             if json_line.startswith("{")]
    assert len(stats) == 2
    assert os.path.exists(os.path.join(multi, "manifest.p1.json"))
    _no_launcher(monkeypatch)
    assert cli.main(["extract", *_CLIPS, "--store", single]) == 0
    _same_clips(FeatureStore(multi).load_all(),
                FeatureStore(single).load_all())
    cfg = dict(n_way=3, k_shot=1, n_query=2, n_episodes=30,
               episodes_per_step=10)
    ref = j_evaluate(JFeatureStore(multi).to_table(), JEvalConfig(**cfg))
    ours = evaluate(FeatureStore(single).to_table("cpu"), EvalConfig(**cfg))
    np.testing.assert_array_equal(np.asarray(ref.per_episode),
                                  ours.per_episode)

    both = str(tmp_path / "ref_writers")
    data = FeatureStore(single).load_all()
    names = FeatureStore(single).class_names
    writers = [JFeatureStore(both, class_names=names, process_index=i)
               for i in (0, 1)]
    for i, vid in enumerate(sorted(data)):
        writers[i % 2].put(vid, data[vid][0], data[vid][1])
    for w in writers:
        w.flush()
    ref = j_evaluate(JFeatureStore(both).to_table(), JEvalConfig(**cfg))
    capsys.readouterr()
    assert cli.main(["eval", "--device", "cpu", "--preset", "synthetic_smoke",
                     "--multichip", "--store", both, "--n-way", "3",
                     "--n-query", "2", "--n-episodes", "30",
                     "--per-episode-out", str(tmp_path / "pe.json")]) == 0
    with open(tmp_path / "pe.json") as f:
        pe = json.load(f)["per_episode"]
    np.testing.assert_array_equal(np.asarray(pe, np.float32),
                                  np.asarray(ref.per_episode))


def test_multichip_without_launcher_is_a_world_of_one(tmp_path, monkeypatch,
                                                      capsys):
    """No launcher and no GPU: ``--multichip`` runs a world of one and says
    so; ``train --multichip`` trains and checkpoints as without it."""
    _no_launcher(monkeypatch)
    run = str(tmp_path / "run")
    args = ["train", "--device", "cpu", "--multichip", "--out", run,
            "--arch", "resnet18", "--batch", "2", "--num-segments", "2",
            "--scale-size", "36", "--crop-size", "32",
            "--synthetic-classes", "3", "--synthetic-clips", "2",
            "--synthetic-height", "40", "--synthetic-width", "48"]
    assert cli.main(args) == 0
    err = capsys.readouterr().err
    assert "world of 1" in err
    assert os.path.exists(os.path.join(run, "step_0", "state.pt"))
    assert not torch.distributed.is_initialized()


def test_multichip_refuses_several_gpus_without_launcher(monkeypatch):
    """Several visible GPUs and no launcher: --multichip raises and names
    the torchrun command (a single process would use one of them)."""
    _no_launcher(monkeypatch)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for cmd in (["extract", *_CLIPS[2:], "--store", "/nonexistent/s"],
                ["eval", "--preset", "synthetic_smoke", "--store",
                 "/nonexistent/s"],
                ["train", "--arch", "resnet18"]):
        with pytest.raises(SystemExit, match="--nproc_per_node 4"):
            cli.main([*cmd, "--multichip", "--device", "cuda"])
