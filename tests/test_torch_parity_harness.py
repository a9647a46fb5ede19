"""The port's parity harness (``eov_tpu_torch/tools/parity_harness.py``)
and its independent model (``tools/torch_ref.py``) on the CPU: the
counterparts of ``tests/test_parity_harness.py``, the model against the
reference's ``eov_tpu/tools/torch_ref.py`` bit for bit, and the report
against the reference's keys (at 64 -> 56 crops: the reference's test
runs 128 -> 112). About 5 s serial.
"""

import argparse

import numpy as np
import pytest
import torch

from eov_tpu.tools import parity_harness as j_ph
from eov_tpu.tools import torch_ref as j_ref

from eov_tpu_torch.models.resnet import random_state_dict
from eov_tpu_torch.tools import parity_harness as ph
from eov_tpu_torch.tools import torch_ref

SMALL = dict(params=None, root=None, split=None, classes=4,
             clips_per_class=2, num_segments=2, scale=64, crop=56,
             dtype="float32", n_episodes=50, seed=0, device="cpu")


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
def report():
    return ph.run(argparse.Namespace(**SMALL))


def test_parity_harness_self_check_small(report):
    """Shared seeded weights: PIL + the torch reference against the port's
    feature program agree per clip and give a zero accuracy delta."""
    assert report["mode"] == "self_check_random_weights"
    assert report["clips"] == 8
    assert report["quant"] is None
    assert report["feature_cosine_min"] > 0.999
    assert report["within_budget"]
    assert report["acc_delta_abs"] <= 0.005


def test_parity_harness_quant_mode():
    """--quant int8 runs pipeline B through the int8 forward against the
    same torch reference, at the quant rails of the reference's test."""
    rep = ph.run(argparse.Namespace(**SMALL, quant="int8"))
    assert rep["quant"] == "int8"
    assert rep["feature_cosine_min"] > 0.99
    assert rep["acc_delta_abs"] <= 0.02


def test_parity_harness_loads_a_torchvision_checkpoint(tmp_path, report):
    """--params: a torchvision-named .pth (num_batches_tracked and a
    1000-way fc included) loads straight into both pipelines."""
    sd = random_state_dict("resnet50", seed=0, num_classes=1000)
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    path = str(tmp_path / "resnet50.pth")
    torch.save(sd, path)
    rep = ph.run(argparse.Namespace(**{**SMALL, "params": path}))
    assert rep["mode"] == "real"
    assert rep["feature_cosine_min"] == report["feature_cosine_min"]
    assert rep["acc_delta_abs"] == report["acc_delta_abs"]


@pytest.mark.parametrize("name", ["TorchResNet18", "TorchResNet50"])
def test_torch_ref_bit_equal_to_reference(name):
    """The port's copy of the independent model gives the reference's
    features bit for bit from the same state dict."""
    arch = "resnet18" if name.endswith("18") else "resnet50"
    sd = random_state_dict(arch, seed=3)
    g = torch.Generator().manual_seed(1)
    for k in [k for k in sd if "running" in k]:  # non-trivial BN statistics
        sd[k] = sd[k] + (0.5 if "var" in k else 0.1) * torch.rand(
            sd[k].shape, generator=g)
    ours, theirs = getattr(torch_ref, name)(), getattr(j_ref, name)()
    for m in (ours, theirs):
        m.load_state_dict(sd, strict=False)
        m.eval()
    x = torch.randn(2, 3, 64, 80, generator=g)
    with torch.no_grad():
        assert torch.equal(ours(x), theirs(x))
    assert sorted(torch_ref.torchvision_style_state_dict(ours)) == sorted(
        j_ref.torchvision_style_state_dict(theirs))


def test_report_keys_match_reference(report, monkeypatch):
    """The reference's harness run (its pipeline B stubbed by its pipeline
    A: no JAX ResNet compile) reports the port's keys."""
    monkeypatch.setattr(j_ph, "_eov_features",
                        lambda v, clips, scale, crop, dtype, quant=None:
                        j_ph._torch_features(v["_sd"], clips, scale, crop))
    from eov_tpu.tools import port_torch  # run() imports it at call time

    monkeypatch.setattr(port_torch, "port_resnet_state_dict",
                        lambda sd: {"_sd": sd})
    small = {k: v for k, v in SMALL.items() if k != "device"}
    ref = j_ph.run(argparse.Namespace(**{**small, "classes": 2,
                                         "clips_per_class": 2,
                                         "num_segments": 1, "scale": 64,
                                         "crop": 56, "n_episodes": 4}))
    assert set(ref) == set(report)
    assert ref["budget"] == report["budget"] == 0.005
    assert np.isclose(ref["feature_cosine_min"], 1.0)
