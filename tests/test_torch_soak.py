"""Kill-and-resume soak of the port's extraction at 2,000 clips.

The reference's ``tests/test_scale_soak.py`` with ``tests/soak_worker.py``,
held against the port: a child process running the port's
``extract_features`` is SIGKILLed mid-extraction (after at least two
durable flushes), then the extraction resumes in this process. The store
must then hold every clip exactly once, every referenced shard on disk,
features that prove which clip made them (from both writers' eras), and
host RSS and manifest reads must stay bounded.

The worker is this file itself: ``python tests/test_torch_soak.py
--worker ROOT N_CLIPS FLUSH_EVERY``. The dataset and the featurizer are
defined here, so the killed process and the resuming one share them. The
featurizer is cheap (the mean pixel of each clip), so the whole soak runs
in seconds on the CPU. ``EOV_SOAK_CLIPS`` sets the size (default 2000).
"""

from __future__ import annotations

import json
import os
import resource
import signal
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # as a script, the worker imports the port
    sys.path.insert(0, ROOT)

from eov_tpu_torch.data.datasets import VideoRecord  # noqa: E402

N_CLIPS = int(os.environ.get("EOV_SOAK_CLIPS", "2000"))
FLUSH_EVERY = 128
K, H, W, D = 4, 32, 40, 64
N_CLASSES = 20


class SoakDataset:
    """Near-free clips whose content is a function of the clip ordinal, so
    any process can check any clip's feature."""

    def __init__(self, n_clips: int, delay_s: float = 0.0):
        self.delay_s = delay_s
        self.class_names = [f"c{i:03d}" for i in range(N_CLASSES)]
        self.records = [VideoRecord(f"soak_{i:06d}", K * 3, i % N_CLASSES)
                        for i in range(n_clips)]

    @staticmethod
    def clip_value(video_id: str) -> int:
        return (int(video_id.split("_")[1]) * 31 + 7) % 251

    def get_frames(self, record: VideoRecord, indices) -> np.ndarray:
        if self.delay_s:
            time.sleep(self.delay_s)
        out = np.empty((len(indices), H, W, 3), np.uint8)
        out[...] = self.clip_value(record.video_id)
        return out


def cheap_feature_fn(frames_u8: torch.Tensor) -> torch.Tensor:
    """[B, K, H, W, 3] uint8 -> [B, D] float32: each row is its clip's mean
    pixel, so the stored feature names the clip that made it."""
    m = frames_u8.reshape(frames_u8.shape[0], -1).float().mean(dim=1)
    return m[:, None].expand(-1, D).contiguous()


def expected_feature(video_id: str) -> np.ndarray:
    return np.full((D,), float(SoakDataset.clip_value(video_id)), np.float32)


def run(root: str, n_clips: int, flush_every: int,
        delay_s: float = 0.0) -> dict:
    from eov_tpu_torch.data.store import FeatureStore
    from eov_tpu_torch.extract import ExtractConfig, extract_features

    ds = SoakDataset(n_clips, delay_s)
    store = FeatureStore(root, class_names=ds.class_names, process_index=0)
    cfg = ExtractConfig(num_segments=K, batch_clips=64,
                        flush_every=flush_every, scale_size=H, crop_size=H)
    return extract_features(ds, None, store, cfg, feature_fn=cheap_feature_fn,
                            device="cpu")


def _wait_for_flushes(proc, manifest: str, n_done: int) -> None:
    deadline = time.time() + 120
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError("worker finished before the kill — raise "
                                 "EOV_SOAK_CLIPS")
        if os.path.exists(manifest):
            with open(manifest) as f:
                try:
                    done = len(json.load(f).get("videos", {}))
                except json.JSONDecodeError:
                    done = 0  # read between the write and the rename
            if done >= n_done:
                return
        time.sleep(0.02)
    raise AssertionError("worker never reached two flushes")


def test_soak_kill_resume_and_bounds(tmp_path):
    from eov_tpu_torch.data.store import FeatureStore

    root = str(tmp_path / "store")
    # Phase 1: a real process, really killed mid-run, once at least two
    # flushes are durable (a shard may be mid-write).
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", root,
         str(N_CLIPS), str(FLUSH_EVERY)],
        env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        _wait_for_flushes(proc, os.path.join(root, "manifest.json"),
                          2 * FLUSH_EVERY)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()

    # Phase 2: resume here, with RSS and timing bounds.
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss  # KiB
    t0 = time.perf_counter()
    done_before = len(FeatureStore(root).done_ids())
    reopen_s = time.perf_counter() - t0
    assert 0 < done_before < N_CLIPS, done_before
    t0 = time.perf_counter()
    stats = run(root, N_CLIPS, FLUSH_EVERY)
    resume_s = time.perf_counter() - t0
    assert stats["skipped_done"] == done_before
    assert stats["extracted"] == N_CLIPS - done_before
    assert stats["failed"] == 0

    # Integrity: every clip exactly once, every referenced shard durable,
    # the killed run's shards and the resume's distinct.
    store = FeatureStore(root)
    t0 = time.perf_counter()
    videos = store._merged_videos()
    merge_s = time.perf_counter() - t0
    assert len(videos) == N_CLIPS
    shards = {m["shard"] for m in videos.values()}
    for s in shards:
        assert os.path.exists(os.path.join(root, s)), s
    assert len(shards) >= 2
    data = store.load_all()
    ds = SoakDataset(N_CLIPS)
    for i in np.linspace(0, N_CLIPS - 1, 50).astype(int):
        vid = ds.records[i].video_id
        feat, label = data[vid]
        np.testing.assert_allclose(feat, expected_feature(vid), atol=0.51)
        assert label == i % N_CLASSES

    # Bounds, loose but enough to catch batches being retained (the raw
    # frames are ~N*K*H*W*3 bytes) or reads growing with N.
    rss_growth_mb = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                     - rss0) / 1024
    assert rss_growth_mb < 400, rss_growth_mb
    assert reopen_s < 5.0, reopen_s
    assert merge_s < 5.0, merge_s
    print(json.dumps({
        "soak_clips": N_CLIPS, "done_at_kill": done_before,
        "resume_wall_s": round(resume_s, 2),
        "clips_per_sec_resume": round((N_CLIPS - done_before) / resume_s, 1),
        "reopen_done_ids_s": round(reopen_s, 4),
        "manifest_merge_s": round(merge_s, 4),
        "rss_growth_mb": round(rss_growth_mb, 1), "shards": len(shards)}))


if __name__ == "__main__":
    if len(sys.argv) != 5 or sys.argv[1] != "--worker":
        raise SystemExit("usage: test_torch_soak.py --worker ROOT N_CLIPS "
                         "FLUSH_EVERY")
    # The worker decodes at most ~500 clips/s, so the kill lands mid-run
    # however loaded the machine is (the resume runs at full speed).
    print(run(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
              delay_s=0.002))
