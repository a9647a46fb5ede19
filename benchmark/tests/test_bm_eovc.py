"""The frozen RAW writer's shards read back by the port's
``EovcVideoDataset`` and by the reference's reader, frame for frame."""

from __future__ import annotations

import numpy as np

from benchmark import data
from benchmark.reference.shards import ShardSet
from benchmark.tests.conftest import TINY_DATA


def test_raw_shards_read_back(tmp_path):
    from eov_tpu_torch.data.datasets import EovcVideoDataset

    d = dict(TINY_DATA, seed=7, clips_per_class=30)  # 90 clips, 2 shards
    root = data.shard_set(str(tmp_path), d)
    assert data.shard_set(str(tmp_path), d) == root  # found, not rewritten
    ds = EovcVideoDataset(root, prefer_native=False)
    ref = ShardSet(root)
    assert len(ds.records) == len(ref.records) == 90
    idx = np.arange(d["frames_per_clip"])
    for i, rec in enumerate(ds.records):
        assert rec.video_id == ref.video_id(i)
        assert rec.label == ref.label(i) == i // 30
        a = ds.get_frames(rec, idx)
        assert a.shape == (4, 40, 52, 3)
        np.testing.assert_array_equal(a, ref.frames(i, idx))
    batch = ds.get_batch(ds.records[60:64], np.stack([idx[::2]] * 4))
    np.testing.assert_array_equal(batch[1], ref.frames(61, idx[::2]))
    # frames and clips differ: the per-frame feature is no constant
    a = ref.frames(0, idx)
    assert (a[0] != a[1]).mean() > 0.5
    assert (ref.frames(1, idx)[0] != a[0]).mean() > 0.5
