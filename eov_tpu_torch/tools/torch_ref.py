"""Hand-written ResNet of ``nn.Conv2d`` / ``nn.BatchNorm2d``: the parity
harness's independent model.

The port's own copy of ``eov_tpu/tools/torch_ref.py``: the canonical
ResNet v1.5 (stride 2 in the 3x3 conv of a bottleneck) written from the
architecture definition, with torchvision's module names, so a torchvision
``resnet50`` state_dict loads into it unchanged. It shares no code with
the port's models (``models/resnet.py``, ``models/folded_infer.py``),
which is what makes it a reference for them: NCHW float32, eval-mode BN
from the running statistics, no fold, no fused stage, no kernel.
"""

from __future__ import annotations

import torch.nn as nn

__all__ = ["TorchBottleneck", "TorchBasicBlock", "TorchResNet18",
           "TorchResNet50", "torchvision_style_state_dict"]


def _downsample(cin: int, cout: int, stride: int):
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                         nn.BatchNorm2d(cout))


class TorchBottleneck(nn.Module):
    def __init__(self, in_ch: int, width: int, stride: int):
        super().__init__()
        out_ch = width * 4
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.relu = nn.ReLU()
        self.downsample = _downsample(in_ch, out_ch, stride)

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + idn)


class TorchBasicBlock(nn.Module):
    def __init__(self, in_ch: int, width: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.relu = nn.ReLU()
        self.downsample = _downsample(in_ch, width, stride)

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + idn)


class _TorchResNet(nn.Module):
    """Stem (7x7/s2 conv, BN, ReLU, 3x3/s2 max-pool), four stages, global
    mean pool, optional fc: NCHW [N, 3, H, W] -> [N, D] (or logits)."""

    def __init__(self, block, stage_sizes, expansion: int, num_classes=None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = 64
        for i, n in enumerate(stage_sizes):
            width = 64 * 2**i
            blocks = []
            for j in range(n):
                blocks.append(block(in_ch, width, 2 if i > 0 and j == 0
                                    else 1))
                in_ch = width * expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(in_ch, num_classes) if num_classes else None

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        x = x.mean(dim=(2, 3))
        if self.fc is not None:
            x = self.fc(x)
        return x


class TorchResNet18(_TorchResNet):
    def __init__(self, num_classes=None):
        super().__init__(TorchBasicBlock, [2, 2, 2, 2], 1, num_classes)


class TorchResNet50(_TorchResNet):
    def __init__(self, num_classes=None):
        super().__init__(TorchBottleneck, [3, 4, 6, 3], 4, num_classes)


def torchvision_style_state_dict(model: nn.Module) -> dict:
    """The model's state_dict as numpy arrays under torchvision's names,
    without the ``num_batches_tracked`` counters."""
    return {k: v.detach().numpy() for k, v in model.state_dict().items()
            if "num_batches_tracked" not in k}

