"""The shard set as the reference reads it: every ``*.eovc`` file of the
directory in name order, each file's clips in index order."""

from __future__ import annotations

import glob
import os

import numpy as np

from benchmark.frozen.eovc_raw import RawReader


class ShardSet:
    def __init__(self, root: str):
        self._readers = [RawReader(p) for p in
                         sorted(glob.glob(os.path.join(root, "*.eovc")))]
        self.records = []  # (reader, clip index, video_id, label, n_frames)
        for r in self._readers:
            for i, (vid, label, n, _) in enumerate(r.clips):
                self.records.append((r, i, vid, label, n))

    def frames(self, rec: int, idx) -> np.ndarray:
        r, i = self.records[rec][:2]
        return r.load_frames(i, [int(f) for f in idx])

    def label(self, rec: int) -> int:
        return self.records[rec][3]

    def video_id(self, rec: int) -> str:
        return self.records[rec][2]
