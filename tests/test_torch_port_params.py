"""extract, classify and episode on a finetuned train run (``--params <run
dir>``, ``--select latest|best``), as the reference's commands take one
(``eov_tpu/cli.py`` ``_resolve_ckpt_dir``), and the .pth path beside it.
All on the CPU at a tiny resnet18.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from eov_tpu_torch import cli
from eov_tpu_torch.data.datasets import SyntheticVideoDataset
from eov_tpu_torch.data.segments import center_indices_np
from eov_tpu_torch.data.store import FeatureStore
from eov_tpu_torch.extract import ExtractConfig, make_feature_fn
from eov_tpu_torch.models.resnet import check_state_dict, random_state_dict
from eov_tpu_torch.utils.checkpoint import read_state

TRAIN = ["--device", "cpu", "--synthetic-classes", "3", "--synthetic-clips",
         "2", "--synthetic-height", "40", "--synthetic-width", "48",
         "--scale-size", "36", "--crop-size", "32", "--batch", "2",
         "--num-segments", "2", "--arch", "resnet18"]
CLIPS = ["--device", "cpu", "--preset", "synthetic_smoke", "--arch",
         "resnet18", "--synthetic-classes", "3", "--synthetic-clips", "2",
         "--synthetic-height", "40", "--synthetic-width", "48",
         "--scale-size", "36", "--crop-size", "32", "--num-segments", "2",
         "--batch", "3"]
CFG = ExtractConfig(arch="resnet18", num_segments=2, batch_clips=3,
                    compute_dtype="float32", scale_size=36, crop_size=32,
                    deterministic=True)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One trained epoch (step_0), and a step_1 whose weights differ, with
    best.json naming step_0: latest and best then pick different
    checkpoints."""
    root = tmp_path_factory.mktemp("params")
    run = str(root / "run")
    assert cli.main(["train", *TRAIN, "--out", run, "--epochs", "1"]) == 0
    doc = read_state(os.path.join(run, "step_0"))
    doc["model"] = {k: v * 0.5 if k.endswith("conv2.weight") else v
                    for k, v in doc["model"].items()}
    os.makedirs(os.path.join(run, "step_1"))
    torch.save(doc, os.path.join(run, "step_1", "state.pt"))
    return run


@pytest.fixture(scope="module")
def store(run, tmp_path_factory):
    """The run's features, extracted with --params <run>."""
    store = str(tmp_path_factory.mktemp("store") / "s")
    assert cli.main(["extract", *CLIPS, "--store", store, "--params",
                     run]) == 0
    return store


def _want(weights) -> dict:
    """make_feature_fn over the dataset in extraction's batches."""
    fn = make_feature_fn(weights, CFG, "cpu")
    ds = SyntheticVideoDataset(n_classes=3, clips_per_class=2, height=40,
                               width=48, seed=0)
    recs = list(ds.records)
    out = {}
    for i in range(0, len(recs), CFG.batch_clips):
        batch = recs[i:i + CFG.batch_clips]
        feats = fn(torch.from_numpy(np.stack([
            ds.get_frames(r, center_indices_np(r.num_frames, 2))
            for r in batch])))
        out.update({r.video_id: feats[j] for j, r in enumerate(batch)})
    return out


def _extracted(store) -> dict:
    return {v: torch.from_numpy(f)
            for v, (f, _) in FeatureStore(store).load_all().items()}


def _model(run, step):
    return check_state_dict(read_state(os.path.join(run, step))["model"],
                            "resnet18")


def _assert_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for v in want:
        assert torch.equal(got[v], want[v]), v


@pytest.mark.parametrize("select,step", [(None, "step_1"),
                                         ("latest", "step_1"),
                                         ("best", "step_0")])
def test_extract_loads_train_run(run, tmp_path, select, step):
    """extract --params <run> writes exactly make_feature_fn's features of
    the checkpoint --select names (the 3-way finetuned fc is ignored)."""
    best = os.path.join(run, "best.json")
    with open(best, "w") as f:
        json.dump({"epoch": 0, "val_acc": 0.5, "ci95": 0.1,
                   "dir": "step_0"}, f)
    try:
        flag = ["--select", select] if select else []
        store = str(tmp_path / "s")
        assert cli.main(["extract", *CLIPS, "--store", store, "--params",
                         run, *flag]) == 0
    finally:
        os.remove(best)
    _assert_equal(_extracted(store), _want(_model(run, step)))


def test_classify_and_episode_accept_train_run(run, store, capsys):
    """classify and episode take the run directory: classify's self-match
    of the run's own store puts every clip in its class."""
    assert cli.main(["classify", *CLIPS, "--store", store, "--params", run,
                     "--select", "latest"]) == 0
    cap = capsys.readouterr()
    lines = [json.loads(s) for s in cap.out.strip().splitlines()]
    assert len(lines) == 6
    assert "accuracy 100.00%" in cap.err
    assert cli.main(["episode", *CLIPS, "--params", run, "--n-way",
                     "3"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["n_way"] == 3 and len(doc["preds"]) == 3


@pytest.mark.parametrize("cmd", ["extract", "classify"])
def test_select_best_without_best_json_exits(run, store, cmd):
    with pytest.raises(SystemExit, match="no best.json under"):
        cli.main([cmd, *CLIPS, "--store", store, "--params", run,
                  "--select", "best"])


def test_train_run_of_another_arch_is_refused(run, tmp_path):
    args = [a if a != "resnet18" else "resnet34" for a in CLIPS]
    with pytest.raises(SystemExit, match="does not load as arch resnet34"):
        cli.main(["extract", *args, "--store", str(tmp_path / "s"),
                  "--params", run])


def test_pth_still_loads(tmp_path):
    """A torchvision .pth (with a head) loads as before."""
    sd = random_state_dict("resnet18", seed=5, num_classes=7)
    pth = str(tmp_path / "w.pth")
    torch.save(sd, pth)
    store = str(tmp_path / "s")
    assert cli.main(["extract", *CLIPS, "--store", store, "--params",
                     pth]) == 0
    _assert_equal(_extracted(store), _want(check_state_dict(sd, "resnet18")))


def test_step_dir_loads_directly(run, tmp_path):
    """--params <run>/step_0 (one checkpoint dir) loads that checkpoint."""
    step = os.path.join(run, "step_0")
    copy = str(tmp_path / "one")
    shutil.copytree(step, copy)
    store = str(tmp_path / "s")
    assert cli.main(["extract", *CLIPS, "--store", store, "--params",
                     copy]) == 0
    _assert_equal(_extracted(store), _want(_model(run, "step_0")))
