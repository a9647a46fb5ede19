"""The benchmark's operation and byte counts against the program's FLOPs
model and the stack counts the kernels' tests use."""

from __future__ import annotations

import pytest
import torch

from benchmark.frozen import flops, peaks


@pytest.mark.parametrize("arch,stages,bottleneck", [
    ("resnet50", (3, 4, 6, 3), True), ("resnet34", (3, 4, 6, 3), False),
    ("resnet18", (2, 2, 2, 2), False), ("resnet101", (3, 4, 23, 3), True)])
@pytest.mark.parametrize("hw,classes", [((224, 224), None), ((224, 224), 64),
                                        ((256, 341), None)])
def test_forward_flops(arch, stages, bottleneck, hw, classes):
    from eov_tpu_torch.utils.flops import resnet_forward_flops

    assert flops.resnet_forward_flops(stages, bottleneck, hw,
                                      num_classes=classes) == \
        resnet_forward_flops(arch, hw, num_classes=classes)


def test_resnet50_8_18_gflop():
    """8.17 GFLOP an image for the backbone, 8.18 with ImageNet's head."""
    got = flops.resnet_forward_flops((3, 4, 6, 3), True, (224, 224))
    assert round(got / 1e9, 2) == 8.17
    got = flops.resnet_forward_flops((3, 4, 6, 3), True, (224, 224),
                                     num_classes=1000)
    assert round(got / 1e9, 2) == 8.18


def _blocks(cin, cmid, cout, n, proj):
    out = []
    for j in range(n):
        b = {"w1": torch.zeros(cin if j == 0 else cout, cmid),
             "w2": torch.zeros(9, cmid, cmid), "w3": torch.zeros(cmid, cout)}
        if proj and j == 0:
            b["wd"] = torch.zeros(cin, cout)
        out.append(b)
    return out


def test_stack_flops_match_the_kernels_counts():
    from eov_tpu_torch.ops.bottleneck import stack_flops_per_img
    from eov_tpu_torch.ops.bottleneck_train import train_stack_flops

    s1, s2 = flops.stage1(), flops.stage2_tail()
    b1, b2 = _blocks(64, 64, 256, 3, True), _blocks(512, 128, 512, 3, False)
    assert s1["flops"] == stack_flops_per_img(b1, 56 * 56)
    assert s2["flops"] == stack_flops_per_img(b2, 28 * 28)
    ops, _ = flops.train_backward_work([s1, s2], 96)
    assert ops == 96 * (train_stack_flops(b1, 3136, backward=True)
                        + train_stack_flops(b2, 784, backward=True))


def test_bytes_and_least_time():
    s1 = flops.stage1()
    ops, byts = flops.infer_stack_work(s1, 256)
    act = 256 * 3136 * (64 + 256) * 2
    assert act < byts < act + 2 * 1024 * 1024
    ops_f, byts_f = flops.train_forward_work([s1], 96)
    assert byts_f > 96 * 3136 * 320 * 4
    _, byts_b = flops.train_backward_work([s1], 96)
    assert byts_b > 96 * 3136 * (2 * 64 + 256) * 4
    kind = "NVIDIA H100 80GB HBM3"
    least = peaks.least_seconds(ops, byts, kind)
    assert least == max(ops / 989.4e12, byts / 3.35e12)
    assert least == pytest.approx(0.3462e-3, rel=0.01)  # chip_smoke's bound
    assert peaks.least_seconds(ops, byts, "cpu") is None
