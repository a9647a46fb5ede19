"""Pack any VideoDataset into EOVC shards (offline).

Counterpart of ``eov_tpu/tools/pack_eovc.py``, in the same format: the
frames are decoded once, resized on the host to the storage short side
(``ops/resize.py``: PIL-exact antialiased bilinear weights as two float32
matmuls, rounded half to even), and written RAW (a read is then a copy) or
as JPEG. A ``classes.json`` sidecar keeps the class names, which the
container does not store. The reference resizes with numpy's einsum; the
sums run in another order here, so a value that lands within rounding of
a half may round one step apart.

Usage:
    python -m eov_tpu_torch.tools.pack_eovc --out DIR --dataset synthetic \\
        --clips-per-shard 36
"""

from __future__ import annotations

import argparse
import io
import json
import os

import numpy as np
import torch

from eov_tpu_torch.data import datasets
from eov_tpu_torch.ops.resize import resize_short_side
from eov_tpu_torch.runtime.eovc import EovcWriter

__all__ = ["resize_short_side_np", "pack", "main"]


def resize_short_side_np(frames: np.ndarray, size: int) -> np.ndarray:
    """Host-side PIL-exact short-side resize of uint8 [F, H, W, 3]."""
    x = torch.from_numpy(frames)
    y = resize_short_side(x.float(), size)
    if y.shape == x.shape:
        return frames
    return y.round_().clamp_(0, 255).to(torch.uint8).numpy()


def _jpeg(frames: np.ndarray, quality: int) -> list[bytes]:
    from PIL import Image

    payloads = []
    for frame in frames:
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
        payloads.append(buf.getvalue())
    return payloads


def pack(dataset, out_path: str, *, storage_short_side: int | None = 256,
         codec: str = "raw", jpeg_quality: int = 90,
         clips_per_shard: int | None = None) -> int:
    """Write ``dataset`` into EOVC storage. Returns the clip count.

    ``clips_per_shard=None`` writes one shard at ``out_path``; otherwise
    ``out_path`` is a directory of ``shard_NNNNN.eovc`` files, which
    ``EovcVideoDataset`` reads as one dataset.
    """
    first = dataset.records[0]
    probe = dataset.get_frames(first, np.array([0]))
    if storage_short_side:
        probe = resize_short_side_np(probe, storage_short_side)
    h, w = probe.shape[1:3]

    if clips_per_shard:
        os.makedirs(out_path, exist_ok=True)
    # The sidecar keeps class names through pack -> extract: embodied
    # fusion aligns virtual banks by class name.
    names = list(getattr(dataset, "class_names", []) or [])
    sidecar = (os.path.join(out_path, "classes.json") if clips_per_shard
               else out_path + ".classes.json")
    if names:
        with open(sidecar, "w") as f:
            json.dump({"class_names": names}, f)
    elif os.path.exists(sidecar):
        # A stale list from an earlier pack of this path would be read
        # against the new labels.
        os.remove(sidecar)

    wr, shard_i, in_shard = None, 0, 0
    for rec in dataset.records:
        if wr is None:
            path = (os.path.join(out_path, f"shard_{shard_i:05d}.eovc")
                    if clips_per_shard else out_path)
            wr = EovcWriter(path, h, w, codec=codec)
        frames = dataset.get_frames(rec, np.arange(rec.num_frames))
        if storage_short_side:
            frames = resize_short_side_np(frames, storage_short_side)
        if frames.shape[1:3] != (h, w):
            raise ValueError(
                f"{rec.video_id}: frame size {frames.shape[1:3]} != "
                f"({h},{w}); EOVC shards are size-normalized — pick a "
                "storage_short_side")
        wr.add_clip(rec.video_id, rec.label,
                    _jpeg(frames, jpeg_quality) if codec == "jpeg"
                    else frames)
        in_shard += 1
        if clips_per_shard and in_shard >= clips_per_shard:
            wr.close()
            wr, in_shard = None, 0
            shard_i += 1
    if wr is not None:
        wr.close()
    return len(dataset.records)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--dataset", default="synthetic",
                    choices=["synthetic", "framedir", "videodir"])
    ap.add_argument("--root")
    ap.add_argument("--split")
    ap.add_argument("--synthetic-classes", type=int, default=10)
    ap.add_argument("--synthetic-clips", type=int, default=8)
    ap.add_argument("--synthetic-height", type=int, default=128)
    ap.add_argument("--synthetic-width", type=int, default=160)
    ap.add_argument("--codec", choices=["raw", "jpeg"], default="raw")
    ap.add_argument("--short-side", type=int, default=256)
    ap.add_argument("--clips-per-shard", type=int, default=None,
                    help="shard the output directory (default: one file)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.dataset == "synthetic":
        ds = datasets.SyntheticVideoDataset(
            n_classes=args.synthetic_classes,
            clips_per_class=args.synthetic_clips,
            height=args.synthetic_height, width=args.synthetic_width,
            seed=args.seed)
    elif args.dataset == "framedir":
        if not (args.root and args.split):
            raise SystemExit("--root and --split required for framedir")
        if args.split.endswith(".json"):
            meta = datasets.load_split_json(args.split)
            split, names = meta["splits"]["all"], meta["class_names"]
        else:
            split = datasets.load_split_txt(args.split)
            names = [str(i) for i in range(max(s[2] for s in split) + 1)]
        ds = datasets.FrameFolderDataset(args.root, split, names)
    else:  # videodir: source videos -> EOVC in one pass
        if not args.root:
            raise SystemExit("--root required for videodir")
        split = None
        if args.split:
            split = (datasets.load_split_json(args.split)["splits"]["all"]
                     if args.split.endswith(".json")
                     else datasets.load_split_txt(args.split))
        ds = datasets.VideoFileDataset(args.root, split)
    n = pack(ds, args.out, storage_short_side=args.short_side,
             codec=args.codec, clips_per_shard=args.clips_per_shard)
    print(f"packed {n} clips -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
