"""Model registry: the ResNet family the port runs (NHWC at its surface)."""

from __future__ import annotations

# name -> (stage_sizes, bottleneck)
ARCHS = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
    "resnet152": ((3, 8, 36, 3), True),
}


def get_arch(name: str) -> tuple[tuple[int, ...], bool]:
    """(stage_sizes, bottleneck) of a registered arch."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "get_arch"]
