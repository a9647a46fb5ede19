"""Model registry: the ResNet family the port runs (NHWC at its surface)."""

from __future__ import annotations

import dataclasses

# name -> (stage_sizes, bottleneck)
ARCHS = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
    "resnet152": ((3, 8, 36, 3), True),
    "tsm_nl_resnet50": ((3, 4, 6, 3), True),
}


@dataclasses.dataclass(frozen=True)
class Temporal:
    """What a video arch adds to its ResNet: TSM's residual temporal shift
    of 1/``shift_div`` of the channels each way on every bottleneck's branch
    input (Lin, Gan, Han 2019, arXiv:1811.08383), and embedded-Gaussian
    non-local blocks after the named blocks (Wang et al. 2018,
    arXiv:1711.07971). A clip's T frames are consecutive rows of the batch;
    T is the caller's number of segments (published: 8)."""
    shift_div: int
    nonlocal_blocks: tuple[str, ...]


# TSM's ResNet-50 with ops/non_local.py:make_non_local's five blocks: after
# layer2 blocks 0 and 2 and layer3 blocks 0, 2 and 4.
TEMPORAL = {
    "tsm_nl_resnet50": Temporal(8, ("layer2.0", "layer2.2", "layer3.0",
                                    "layer3.2", "layer3.4")),
}


def get_arch(name: str) -> tuple[tuple[int, ...], bool]:
    """(stage_sizes, bottleneck) of a registered arch."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_temporal(name: str) -> Temporal | None:
    """The arch's shift and non-local blocks; None for a frame-wise arch."""
    get_arch(name)
    return TEMPORAL.get(name)


__all__ = ["ARCHS", "TEMPORAL", "Temporal", "get_arch", "get_temporal"]
