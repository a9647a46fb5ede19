"""The port's train loop, checkpoints and train/test CLI on the CPU: the
epoch loop against the JAX reference's on a mixed-resolution fixture, then
train -> checkpoint -> resume -> test, meta-val selection into best.json,
and the warm-start guards.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from eov_tpu import train as jtr

from eov_tpu_torch import cli, prng
from eov_tpu_torch import train as ttr
from eov_tpu_torch.data.datasets import SyntheticVideoDataset
from eov_tpu_torch.models.resnet import from_jax_variables, random_state_dict
from eov_tpu_torch.utils.checkpoint import (latest_step_dir, load_state,
                                            read_state, save_state)


class _Record:
    def __init__(self, video_id, num_frames, label):
        self.video_id, self.num_frames, self.label = (video_id, num_frames,
                                                      label)


class MixedResolutionDataset:
    """Seeded uint8 clips at two frame sizes (the loop buckets per
    resolution and wrap-pads each bucket's tail); serves both packages."""

    def __init__(self):
        self.class_names = ["a", "b", "c"]
        sizes = [(40, 48)] * 4 + [(36, 44)] * 3
        self.records, self._hw = [], {}
        for i, hw in enumerate(sizes):
            rec = _Record(f"v{i}", 5 + 3 * i, i % 3)
            self.records.append(rec)
            self._hw[rec.video_id] = hw

    def get_frames(self, record, indices):
        h, w = self._hw[record.video_id]
        rng = np.random.default_rng(int(record.video_id[1:]))
        clip = rng.integers(0, 256, (record.num_frames, h, w, 3),
                            dtype=np.uint8)
        return clip[np.asarray(indices)]


BASE = dict(num_classes=3, num_segments=2, batch_clips=2,
            compute_dtype="float32", scale_size=36, crop_size=32,
            dropout=0.0, lr=0.01, arch="resnet18")


def test_train_epoch_matches_reference():
    """Same order, TSN indices, buckets, wrap-padding and step keys as the
    reference's single-process loop: equal step and clip counts, last loss
    and accuracy within 1e-4 (f32, dropout 0)."""
    ds = MixedResolutionDataset()
    jcfg = jtr.TrainConfig(**BASE)
    jstate = jtr.create_train_state(jcfg, jax.random.PRNGKey(0),
                                    sample_hw=(32, 32))
    weights = from_jax_variables(jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats}))
    jstate, jm = jtr.train_epoch(jstate, jtr.make_train_step(jcfg), jcfg, ds,
                                 epoch=1)
    cfg = ttr.TrainConfig(**BASE)
    state = ttr.create_train_state(cfg, "cpu", weights=weights)
    state, m = ttr.train_epoch(state, ttr.make_train_step(cfg, "cpu"), cfg,
                               ds, epoch=1)
    assert (m["steps"], m["clips"]) == (jm["steps"], jm["clips"]) == (4, 7)
    assert state.step == 4
    assert abs(m["loss"] - jm["loss"]) < 1e-4
    assert abs(m["accuracy"] - jm["accuracy"]) < 1e-4
    want = from_jax_variables(jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats}))
    sd = state.model.state_dict()
    for k in ("conv1.weight", "bn1.running_var", "layer4.1.conv2.weight",
              "fc.weight"):
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                   atol=1e-4, rtol=0, err_msg=k)
    with pytest.raises(NotImplementedError):
        ttr.train_epoch(state, None, cfg, ds, mesh=object())


SYN = ["--device", "cpu", "--synthetic-classes", "3", "--synthetic-clips",
       "2", "--synthetic-height", "40", "--synthetic-width", "48",
       "--scale-size", "36", "--crop-size", "32", "--batch", "2",
       "--num-segments", "2", "--arch", "resnet18"]


def test_cli_train_checkpoint_resume_test(tmp_path, capsys):
    """train writes step_0, a second train resumes at epoch 1 and writes
    step_1 with the step count carried over, test scores the newest."""
    run = str(tmp_path / "run")
    assert cli.main(["train", *SYN, "--out", run, "--epochs", "1"]) == 0
    assert latest_step_dir(run) == os.path.join(run, "step_0")
    first = read_state(os.path.join(run, "step_0"))
    assert first["step"] == 3 and "fc.weight" in first["model"]
    assert first["optimizer"]["state"], "momentum buffers are saved"
    assert cli.main(["train", *SYN, "--out", run, "--epochs", "2"]) == 0
    out = capsys.readouterr().out
    assert f"resumed from {os.path.join(run, 'step_0')} (epoch 1)" in out
    assert read_state(os.path.join(run, "step_1"))["step"] == 6
    assert cli.main(["test", *SYN, "--params", run]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["n"] == 6 and 0.0 <= doc["top1"] <= 1.0
    with pytest.raises(SystemExit, match="finetuned"):
        cli.main(["test", *SYN, "--params", str(tmp_path / "w.pth")])
    with pytest.raises(SystemExit, match="best.json"):
        cli.main(["test", *SYN, "--params", run, "--select", "best"])
    with pytest.raises(SystemExit, match="not ported"):
        cli.main(["train", *SYN, "--multichip"])
    # --val-class-split is ported: it reads the split, which is missing here
    with pytest.raises(FileNotFoundError, match="s.json"):
        cli.main(["train", *SYN, "--val-class-split",
                  str(tmp_path / "s.json")])


def test_meta_val_selection_writes_best_json(tmp_path, capsys):
    """With a meta-val dataset each epoch is scored by one-shot episodes
    through extract -> store -> eval, and best.json names the winner that
    test --select best then loads."""
    cfg = ttr.TrainConfig(**{**BASE, "batch_clips": 4})
    train_ds = SyntheticVideoDataset(n_classes=3, clips_per_class=2,
                                     height=40, width=48, seed=0)
    val_ds = SyntheticVideoDataset(n_classes=5, clips_per_class=2,
                                   height=40, width=48, seed=9, name="val")
    run = str(tmp_path / "run")
    cli.run_training(cfg, train_ds, device=torch.device("cpu"), epochs=2,
                     out=run, val_dataset=val_ds, val_episodes=10,
                     val_segments=2)
    with open(os.path.join(run, "best.json")) as f:
        best = json.load(f)
    assert best["dir"] in ("step_0", "step_1") and 0 <= best["val_acc"] <= 1
    assert "meta-val one-shot accuracy: " in capsys.readouterr().out
    assert cli.main(["test", *SYN, "--params", run, "--select", "best"]) == 0


def test_one_shot_validate_matches_direct_eval():
    """one_shot_validate == extracting with the state's weights and
    evaluating the table directly (the same episodes)."""
    import tempfile

    from eov_tpu_torch.data.store import FeatureStore
    from eov_tpu_torch.eval import EvalConfig, evaluate
    from eov_tpu_torch.extract import ExtractConfig, extract_features

    cfg = ttr.TrainConfig(**BASE)
    state = ttr.create_train_state(cfg, "cpu")
    ds = SyntheticVideoDataset(n_classes=5, clips_per_class=2, height=40,
                               width=48, seed=3)
    res = ttr.one_shot_validate(state, cfg, ds, n_episodes=20,
                                num_segments=2)
    with tempfile.TemporaryDirectory() as tmp:
        store = FeatureStore(tmp, class_names=ds.class_names, quant=None)
        extract_features(ds, state.model.state_dict(), store, ExtractConfig(
            num_segments=2, arch="resnet18", scale_size=36, crop_size=32,
            compute_dtype="float32", deterministic=True), device="cpu")
        want = evaluate(store.to_table("cpu"),
                        EvalConfig(n_episodes=20, episodes_per_step=20))
    np.testing.assert_array_equal(res.per_episode, want.per_episode)


def test_warm_start_guards(tmp_path, capsys):
    """A donor head of another width is dropped (fresh fc); a donor of
    another arch, or one missing tensors, is refused."""
    cfg = ttr.TrainConfig(**BASE)
    donor = random_state_dict("resnet18", seed=4, num_classes=10)
    path = str(tmp_path / "donor.npz")
    np.savez(path, **{k: v.numpy() for k, v in donor.items()})
    state = ttr.create_train_state(cfg, "cpu")
    fc_before = state.model.fc.weight.detach().clone()
    cli.warm_start(state, path, num_classes=3)
    assert "keeping a fresh fc" in capsys.readouterr().err
    assert torch.equal(state.model.fc.weight, fc_before)
    assert torch.equal(state.model.layer1[0].conv1.weight,
                       donor["layer1.0.conv1.weight"])
    other = random_state_dict("resnet34", seed=4)
    np.savez(path, **{k: v.numpy() for k, v in other.items()})
    with pytest.raises(SystemExit, match="does not have"):
        cli.warm_start(state, path, num_classes=3)
    del donor["layer2.0.conv1.weight"]
    np.savez(path, **{k: v.numpy() for k, v in donor.items()})
    with pytest.raises(SystemExit, match="missing"):
        cli.warm_start(state, path, num_classes=3)
    # a train run warm-starts from its newest checkpoint's model
    save_state(str(tmp_path / "run" / "step_0"), state)
    fresh = ttr.create_train_state(cfg, "cpu")
    cli.warm_start(fresh, str(tmp_path / "run"), num_classes=3)
    assert torch.equal(fresh.model.fc.weight, state.model.fc.weight)


def test_checkpoint_round_trip(tmp_path):
    cfg = ttr.TrainConfig(**BASE)
    state = ttr.create_train_state(cfg, "cpu")
    step = ttr.make_train_step(cfg, "cpu")
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 2, 40, 48, 3), dtype=np.uint8))
    state, _ = step(state, frames, torch.tensor([0, 2]), prng.key(1))
    save_state(str(tmp_path / "step_0"), state)
    back = load_state(str(tmp_path / "step_0"),
                      ttr.create_train_state(cfg, "cpu"))
    assert back.step == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k
    # the restored momentum continues the run identically
    a, ma = step(state, frames, torch.tensor([0, 2]), prng.key(2))
    b, mb = step(back, frames, torch.tensor([0, 2]), prng.key(2))
    assert float(ma["loss"]) == float(mb["loss"])
    assert torch.equal(a.model.fc.weight, b.model.fc.weight)
    assert not os.path.exists(str(tmp_path / "step_0" / "state.pt.tmp"))


def test_train_entry_points_need_cuda_by_default():
    """Without a GPU, the default-device train entry points raise instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    cfg = ttr.TrainConfig(**BASE)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.create_train_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.make_train_step(cfg)
    for cmd in ("train", "test"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([cmd, "--synthetic-classes", "2"])
