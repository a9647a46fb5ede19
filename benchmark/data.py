"""The cells' clips, written as RAW EOVC shards and kept between runs.

A shard set is fixed by its sizes and its data seed (``data`` in the
traffic file): classes x clips per class, frames per clip, frame height and
width. Each frame is a colour pattern of 32-pixel blocks drawn from the data
seed, with a fixed pixel noise, so clips and their frames differ as real
ones do (a per-frame feature is not a constant). Clip ``j`` of class ``c``
is ``c{c:03d}_v{j:02d}``; 64 clips a shard. The set is written once under
the checkout's cache directory (``.benchcache/shards/<key>``) and reused by
every later run that asks for the same sizes.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from benchmark.frozen.eovc_raw import RawWriter

CLIPS_PER_SHARD = 64


def shard_key(d: dict) -> str:
    return (f"c{d['classes']}x{d['clips_per_class']}_f{d['frames_per_clip']}"
            f"_{d['height']}x{d['width']}_s{d['seed']}")


def _clip(rng, noise, f: int, h: int, w: int) -> np.ndarray:
    lh, lw = -(-h // 32), -(-w // 32)
    low = rng.integers(0, 256, (f, lh, lw, 3), dtype=np.int16)
    big = np.repeat(np.repeat(low, 32, axis=1), 32, axis=2)[:, :h, :w]
    return np.clip(big + noise, 0, 255).astype(np.uint8)


def shard_set(cache: str, d: dict) -> str:
    """The directory of the shard set ``d`` describes, written if absent."""
    root = os.path.join(cache, "shards", shard_key(d))
    if os.path.exists(os.path.join(root, "done")):
        return root
    tmp = f"{root}.partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    rng = np.random.default_rng(d["seed"])
    h, w, f = d["height"], d["width"], d["frames_per_clip"]
    noise = rng.integers(-12, 13, (1, h, w, 3), dtype=np.int16)
    clips = [(c, j) for c in range(d["classes"])
             for j in range(d["clips_per_class"])]
    for s in range(0, len(clips), CLIPS_PER_SHARD):
        wr = RawWriter(os.path.join(tmp, f"shard_{s // CLIPS_PER_SHARD:04d}"
                                         ".eovc"), h, w)
        for c, j in clips[s:s + CLIPS_PER_SHARD]:
            wr.add_clip(f"c{c:03d}_v{j:02d}", c, _clip(rng, noise, f, h, w))
        wr.close()
    open(os.path.join(tmp, "done"), "w").close()
    shutil.rmtree(root, ignore_errors=True)
    os.replace(tmp, root)
    return root
