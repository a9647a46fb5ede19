"""Video dataset records and the synthetic fixture dataset.

Counterpart of ``eov_tpu/data/datasets.py`` (``VideoRecord``,
``VideoDataset``, ``SyntheticVideoDataset``). Datasets are thin host-side
index structures; batching, decode overlap and device transfer belong to
extract.py. Frame folders, video files and EOVC shards are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence

import numpy as np

from eov_tpu_torch.data import fixtures

__all__ = ["VideoRecord", "VideoDataset", "SyntheticVideoDataset"]


@dataclasses.dataclass(frozen=True)
class VideoRecord:
    """One video: stable id, frame count, integer label."""

    video_id: str
    num_frames: int
    label: int


class VideoDataset(Protocol):
    """Minimal dataset protocol consumed by extract.py."""

    records: Sequence[VideoRecord]
    class_names: Sequence[str]

    def get_frames(self, record: VideoRecord,
                   indices: np.ndarray) -> np.ndarray:
        """uint8 [len(indices), H, W, 3] RGB frames at the given indices."""
        ...


class SyntheticVideoDataset:
    """Procedural fixture dataset — deterministic, no IO; the same records
    and frames as the reference's for the same arguments."""

    def __init__(self, n_classes: int = 10, clips_per_class: int = 8,
                 min_frames: int = 24, max_frames: int = 60,
                 height: int = 128, width: int = 160, seed: int = 0,
                 name: str = "synthetic", virtual: bool = False):
        self._virtual = virtual
        self.name = name
        self.height, self.width = height, width
        if virtual:
            self.class_names = [f"{name.capitalize()} Class {c:03d}"
                                for c in range(n_classes)]
        else:
            self.class_names = [f"{name}_class_{c:03d}"
                                for c in range(n_classes)]
        rng = np.random.default_rng(seed)
        self.records = []
        self._meta = {}
        for c in range(n_classes):
            for j in range(clips_per_class):
                vid = f"{name}_c{c:03d}_v{j:03d}"
                f = int(rng.integers(min_frames, max_frames + 1))
                self.records.append(VideoRecord(vid, f, c))
                self._meta[vid] = (c, j)

    def get_frames(self, record: VideoRecord,
                   indices: np.ndarray) -> np.ndarray:
        c, j = self._meta[record.video_id]
        render = (fixtures.synthetic_virtual_clip if self._virtual
                  else fixtures.synthetic_clip)
        clip = render(c, j, record.num_frames, self.height, self.width)
        return clip[np.asarray(indices)]
