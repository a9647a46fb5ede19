"""The TSM + non-local cell (``tsm_nl_r50_finetune``) on the CPU at a tiny
size: it loads by name, its run is ``correct`` at the cell's own limits,
each fault planted in the program turns ``correct`` false, and the
counting function gives the hand counts of a block's work.

The program runs in float32 here: at a 32x32 crop the batch-statistics BNs
of the last stages see a few values a channel, and bf16's rounding alone
reads above the limits set at the cell's size (``loss_gap`` 2.5e-3 against
6e-4), while float32 reads 2.4e-4.

Faults: the shift left out, its two directions swapped, the non-local
blocks left out, their softmax scaled by 1/√Ci, every BN on its running
statistics; and the training faults of ``test_bm_faults.py``: a state left
unchanged, half of each batch, the momentum reset at an epoch's start,
every epoch in epoch 0's order.
"""

from __future__ import annotations

import math

import pytest

from benchmark import manifest
from benchmark import run as R
from benchmark.tests.conftest import REPO, tiny_cell
from benchmark.tests.test_bm_faults import (SEED, _epoch_repeated,
                                            _half_batch, _momentum_reset,
                                            _unchanged)

CELL = "tsm_nl_r50_finetune"


def _run(root):
    cell = tiny_cell(CELL)
    cell.config["compute_dtype"] = "float32"
    return R.run_cell(cell, SEED, 1, False, "cpu", root=str(root))


def _shift_off(monkeypatch):
    from eov_tpu_torch.models import resnet

    monkeypatch.setattr(resnet, "temporal_shift", lambda x, t, fold: x)


def _shift_swapped(monkeypatch):
    from eov_tpu_torch.models import resnet
    from eov_tpu_torch.ops.temporal_shift import shift_plain

    monkeypatch.setattr(resnet, "temporal_shift", lambda x, t, fold: (
        shift_plain(x, t, fold, reverse=True)))


def _nonlocal_off(monkeypatch):
    from eov_tpu_torch.models import resnet

    monkeypatch.setattr(resnet.NonLocal, "forward", lambda self, z: z)


def _nonlocal_scaled(monkeypatch):
    from eov_tpu_torch.models import resnet

    real = resnet.nonlocal_attention

    def scaled(theta, phi, g, segments):
        return real(theta / math.sqrt(theta.shape[1]), phi, g, segments)
    monkeypatch.setattr(resnet, "nonlocal_attention", scaled)


def _running_stats(monkeypatch):
    from eov_tpu_torch.models import resnet

    real = resnet.BatchNorm.forward

    def frozen(self, x):
        was, self.training = self.training, False
        try:
            return real(self, x)
        finally:
            self.training = was
    monkeypatch.setattr(resnet.BatchNorm, "forward", frozen)


def test_cell_loads():
    cell = manifest.load_cell(REPO, CELL)
    assert cell.job == "tsm_finetune" and cell.chips == 1
    assert cell.config["arch"] == "tsm_nl_resnet50"
    assert cell.config["partial_bn"] is False
    assert (cell.traffic["batch_clips_per_chip"]
            * cell.config["train_segments"]) == 128
    assert set(cell.limits) >= {"loss_gap", "window_loss_gap"}
    names = {m["name"] for m in cell.per_layer}
    assert {"train_mfu.tsm_nl", "nonlocal_share.train",
            "shift_roofline.train"} <= names
    assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                    "train_clips_per_s"]


def test_counts_match_hand_counts():
    """≈ 8.3 G multiply-accumulates a res3 block and ≈ 3.9 G a res4 one a
    clip at 224², T 8; 32.7 G for the ResNet-50 convs and fc."""
    from benchmark.frozen import flops
    from benchmark.metrics import _tsm_nl as W

    cfg = manifest.load_cell(REPO, CELL).config
    assert round(W.nonlocal_macs(8, 28, 512) / 1e9, 1) == 8.3
    assert round(W.nonlocal_macs(8, 14, 1024) / 1e9, 1) == 3.9
    resnet_macs = 8 * flops.resnet_forward_flops(
        cfg["stage_sizes"], True, (224, 224), num_classes=64) / 2
    assert round(resnet_macs / 1e9, 1) == 32.7
    nl = W.forward_flops_per_clip(cfg) / 2 - resnet_macs
    assert round(nl / 1e9, 1) == 28.4  # 2 x 8.32 + 3 x 3.92
    # The shift: stage 1's first input, 56² x 64, then 56² x 256 ...
    blocks = W._blocks(cfg)
    assert [b[1:3] for b in blocks[:4]] == [(56, 64), (56, 256), (56, 256),
                                           (56, 256)]
    assert W.shift_bytes_per_image(cfg) == sum(
        4 * s * s * c * 2 for _, s, c, _, _ in blocks)


def test_tsm_sound(tmp_path):
    got = _run(tmp_path)
    assert got["correct"], got["checks"]


@pytest.mark.parametrize("fault", [_shift_off, _shift_swapped,
                                   _nonlocal_off, _nonlocal_scaled,
                                   _running_stats, _unchanged, _half_batch,
                                   _momentum_reset, _epoch_repeated])
def test_tsm_faults(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    got = _run(tmp_path)
    assert got["correct"] is False, got["checks"]
