"""The plain reference against the port at a tiny size on the CPU, in
float32: where both compute the same function, they agree to rounding."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import data
from benchmark.frozen import threefry
from benchmark.reference import extract as ref_extract
from benchmark.reference import resnet, tsn
from benchmark.reference import train as ref_train
from benchmark.reference.shards import ShardSet
from benchmark.tests.conftest import tiny_cell


def test_threefry_is_the_ports():
    from eov_tpu_torch import prng

    for seed in (0, 7, 2 ** 31 + 5, 2 ** 40 + 3):
        k = threefry.key(seed)
        assert torch.equal(k, prng.key(seed))
        assert torch.equal(threefry.split(k, 5), prng.split(k, 5))
        assert torch.equal(threefry.fold_in(k, 1), prng.fold_in(k, 1))
        ks = threefry.split(k, 32)
        assert torch.equal(threefry.randint(ks, (), 0, 13),
                           prng.randint(ks, (), 0, 13))
        assert torch.equal(threefry.bernoulli(ks), prng.bernoulli(ks))


@pytest.mark.parametrize("arch,cfg_name", [("resnet50", "resnet50_tsn"),
                                           ("resnet34", "resnet34_tsn")])
def test_forward_is_the_ports(arch, cfg_name):
    from eov_tpu_torch.models.resnet import ResNet

    cfg = tiny_cell("r50_finetune" if arch == "resnet50"
                    else "r34_finetune").config
    p = resnet.make_weights(cfg, 3, "cpu")
    model = ResNet(arch, num_classes=cfg["num_classes"])
    model.load_state_dict(p)
    model.eval()
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = model(x)
        want = resnet.forward(p, cfg, x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_multiscale_is_the_ports():
    from eov_tpu_torch import prng
    from eov_tpu_torch.ops.preprocess import preprocess_train_multiscale

    g = torch.Generator().manual_seed(1)
    frames = torch.randint(0, 256, (5, 2, 40, 52, 3), generator=g,
                           dtype=torch.uint8)
    key = threefry.key(99)
    want = tsn.train_preprocess(frames, key, 5, scale=40, crop=32)
    got = preprocess_train_multiscale(prng.split(key, 5), frames,
                                      scale_size=40, crop_size=32,
                                      dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_first_steps_are_the_ports_in_f32(tmp_path):
    """Three f32 steps of the port's epoch loop against the reference's."""
    from eov_tpu_torch import train as T
    from eov_tpu_torch.data.datasets import EovcVideoDataset

    from benchmark.jobs import finetune as FT

    cell = tiny_cell("r50_finetune")
    cfg = dict(cell.config, compute_dtype="float32")
    root = data.shard_set(str(tmp_path), dict(cell.traffic["data"], seed=3))
    seed = 2 ** 31 + 11
    tcfg = FT.train_config(cfg, cell.traffic, seed, 1)
    p0 = resnet.make_weights(cfg, seed, "cpu")
    state = T.create_train_state(tcfg, "cpu", weights=p0)
    step = T.make_train_step(tcfg, "cpu")
    rec = {}

    def recording(st, frames, labels, key):
        st, m = step(st, frames, labels, key)
        rec.setdefault("loss", []).append(float(m["loss"]))
        named = dict(st.model.named_parameters())
        if st.step == 1:
            rec["buf"] = {n: st.optimizer.state[p]["momentum_buffer"].clone()
                          for n, p in named.items() if p in st.optimizer.state}
        if st.step == 3:
            rec["p3"] = {n: p.detach().clone() for n, p in named.items()}
        return st, m

    T.train_epoch(state, recording, tcfg, EovcVideoDataset(
        root, prefer_native=False), epoch=0)
    ref = ref_train.first_steps(p0, cfg, {"batch_clips": 2}, ShardSet(root),
                                seed, "cpu")
    job = FT.Job.__new__(FT.Job)
    job.record, job.cfg = {"setup": rec}, cfg
    job.run = type("R", (), {"device": torch.device("cpu")})()
    got = FT.gaps(job.program_side(p0, "setup"), ref)
    assert got["loss_gap"] < 1e-5
    # a ReLU at a knife edge moves the later steps' sums a little
    assert got["grad_gap"] < 1e-5 and got["update_gap"] < 1e-3


def test_features_are_the_ports_in_f32(tmp_path):
    from eov_tpu_torch.extract import ExtractConfig, make_feature_fn

    cell = tiny_cell("r50_extract")
    cfg = dict(cell.config, compute_dtype="float32")
    root = data.shard_set(str(tmp_path), dict(cell.traffic["data"], seed=4))
    shards = ShardSet(root)
    p = resnet.make_weights(cfg, 5, "cpu")
    k = cfg["extract_segments"]
    recs = list(range(4))
    want = ref_extract.features(p, cfg, shards, recs, "cpu", k=k)
    fn = make_feature_fn(p, ExtractConfig(
        num_segments=k, scale_size=40, crop_size=32,
        compute_dtype="float32"), "cpu")
    clips = np.stack([shards.frames(r, tsn.center_indices(
        shards.records[r][4], k)) for r in recs])
    got = fn(torch.from_numpy(clips))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_both_phases_are_the_ports_in_f32(tmp_path):
    """A run of the tiny cell in f32 on the CPU: the set-up's epoch 0 from
    the seed's weights and the window's first epoch from the state it
    started from, each against the reference."""
    from benchmark import run as R

    cell = tiny_cell("r50_finetune")
    cell.config["compute_dtype"] = "float32"
    got = R.run_cell(cell, 2 ** 31 + 13, 1, False, "cpu",
                     root=str(tmp_path))
    c = {k: v["value"] for k, v in got["checks"].items()}
    for prefix in ("", "window_"):
        assert c[prefix + "loss_gap"] < 1e-5, c
        assert c[prefix + "grad_gap"] < 1e-4, c
        assert c[prefix + "update_gap"] < 1e-3, c
