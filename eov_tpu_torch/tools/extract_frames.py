"""Video files -> TSN frame folders (offline).

Counterpart of ``eov_tpu/tools/extract_frames.py``. Scans
``--videos root/<class>/<clip>.{mp4,avi,mkv,mov,webm,mpg,mpeg}`` (videos
directly under the root get class ``_unlabeled``), decodes every frame
with OpenCV's ``cv2.VideoCapture``, optionally resizes to a storage short
side with the pipeline's PIL-exact resize (``tools/pack_eovc.py``), and
writes the TSN frame-folder layout that ``FrameFolderDataset`` reads::

    out/<class>/<clip>/img_00001.jpg     (1-based, RGB JPEGs)

plus ``out/split_all.txt`` (``<video_id> <num_frames> <label>`` lines,
labels in sorted class-directory order) and ``out/classes.txt``::

    python -m eov_tpu_torch.tools.extract_frames --videos raw/ --out frames/
    python -m eov_tpu_torch.cli extract --dataset framedir --root frames/ \\
        --split frames/split_all.txt ...

A video that fails to decode is skipped and logged, never fatal. ``cv2``
and PIL are imported inside the calls that use them (a machine without
them can still import this module).
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

__all__ = ["VIDEO_EXTS", "list_videos", "decode_video", "write_frame_folder",
           "extract_all", "main"]

log = logging.getLogger("eov_tpu_torch.extract_frames")

VIDEO_EXTS = (".mp4", ".avi", ".mkv", ".mov", ".webm", ".mpg", ".mpeg")


def list_videos(root: str) -> list[tuple[str, str, str]]:
    """-> [(class_name, clip_stem, path)], classes in sorted order."""
    out = []
    for entry in sorted(os.listdir(root)):
        p = os.path.join(root, entry)
        if os.path.isdir(p):
            out += [(entry, os.path.splitext(f)[0], os.path.join(p, f))
                    for f in sorted(os.listdir(p))
                    if f.lower().endswith(VIDEO_EXTS)]
        elif entry.lower().endswith(VIDEO_EXTS):
            out.append(("_unlabeled", os.path.splitext(entry)[0], p))
    return out


def decode_video(path: str, *, every: int = 1,
                 max_frames: int = 0) -> np.ndarray:
    """A video file -> uint8 RGB [F, H, W, 3]: every ``every``-th frame, at
    most ``max_frames`` (0 = all)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"VideoCapture failed to open: {path}")
    frames = []
    i = 0
    try:
        while True:
            ok, img = cap.read()
            if not ok:
                break
            if i % every == 0:
                frames.append(img[:, :, ::-1])  # BGR -> RGB
                if max_frames and len(frames) >= max_frames:
                    break
            i += 1
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames decoded: {path}")
    return np.stack(frames)


def write_frame_folder(frames: np.ndarray, clip_dir: str, *,
                       quality: int = 90,
                       image_tmpl: str = "img_{:05d}.jpg") -> None:
    """uint8 RGB [F, H, W, 3] -> a 1-based JPEG frame folder."""
    from PIL import Image

    os.makedirs(clip_dir, exist_ok=True)
    for i, frame in enumerate(frames):
        Image.fromarray(frame).save(
            os.path.join(clip_dir, image_tmpl.format(i + 1)),
            quality=quality)


def extract_all(videos_root: str, out_root: str, *, short_side: int = 0,
                every: int = 1, max_frames: int = 0,
                quality: int = 90) -> dict:
    """Every video under ``videos_root`` -> frame folders under
    ``out_root``. Returns {"extracted", "failed", "split", "classes"}, the
    split as [(video_id, num_frames, label)] over the sorted classes."""
    from eov_tpu_torch.tools.pack_eovc import resize_short_side_np

    vids = list_videos(videos_root)
    classes = sorted({c for c, _, _ in vids})
    label = {c: i for i, c in enumerate(classes)}
    split, failed = [], 0
    for cls, stem, path in vids:
        try:
            frames = decode_video(path, every=every, max_frames=max_frames)
            if short_side:
                frames = resize_short_side_np(frames, short_side)
            write_frame_folder(frames, os.path.join(out_root, cls, stem),
                               quality=quality)
            split.append((f"{cls}/{stem}", len(frames), label[cls]))
        except Exception as e:  # noqa: BLE001 — skip and log, never fatal
            failed += 1
            log.warning("skipping %s: %s", path, e)
    return {"extracted": len(split), "failed": failed, "split": split,
            "classes": classes}


def main(argv=None) -> int:
    from eov_tpu_torch.data.datasets import save_split_txt

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--videos", required=True,
                    help="root of <class>/<clip>.<ext> video files")
    ap.add_argument("--out", required=True, help="frame-folder output root")
    ap.add_argument("--short-side", type=int, default=0,
                    help="storage resize (0 = keep the source resolution)")
    ap.add_argument("--every", type=int, default=1,
                    help="keep every Nth frame (temporal subsample)")
    ap.add_argument("--max-frames", type=int, default=0,
                    help="cap the frames per clip (0 = all)")
    ap.add_argument("--quality", type=int, default=90, help="JPEG quality")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    res = extract_all(args.videos, args.out, short_side=args.short_side,
                      every=args.every, max_frames=args.max_frames,
                      quality=args.quality)
    os.makedirs(args.out, exist_ok=True)
    save_split_txt(os.path.join(args.out, "split_all.txt"), res["split"])
    with open(os.path.join(args.out, "classes.txt"), "w") as f:
        f.write("\n".join(res["classes"]) + "\n")
    print({"extracted": res["extracted"], "failed": res["failed"],
           "classes": len(res["classes"])})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
