"""Shared fixtures of the benchmark's CPU tests: a cell cut to a size the
CPU runs in seconds (the same code paths, tiny shapes), run in a scratch
checkout root."""

from __future__ import annotations

import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY_DATA = {"classes": 3, "clips_per_class": 2, "frames_per_clip": 4,
             "height": 40, "width": 52}


def tiny_cell(name: str, **limits):
    """The manifest's cell ``name`` at a CPU size."""
    from benchmark import manifest

    cell = manifest.load_cell(REPO, name)
    cell.config.update(crop_size=32, scale_size=40)
    cell.traffic.update(batch_clips_per_chip=2, batch_clips=2,
                        trace_seconds=1)
    cell.traffic["data"] = dict(cell.traffic["data"], **TINY_DATA)
    cell.limits = dict(cell.limits, **limits)
    return cell


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
