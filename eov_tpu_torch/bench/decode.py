"""Decode bench: host clip-decode throughput, one JSON line per path.

Counterpart of the reference's ``bench_decode.py`` (the host side only;
no device work). Synthetic 256x320 clips (24-32 frames) are packed by
``tools/pack_eovc`` into EOVC shards (RAW and JPEG) in a temporary
directory, then each path reads ``EOV_DECODE_CLIPS`` clips x
``EOV_DECODE_K`` frames with ``get_batch`` into one reused buffer (the
extraction's buffer ring): the median of 3 calls after a first call that
allocates the buffer (``coldbuf_clips_per_s``).

Paths (``detail.path``; ``detail.reader`` names the reader that ran):

    eovc_raw              RAW shard, native loader (mmap + thread pool)
    python_raw            RAW shard, the python reader
    eovc_jpeg             JPEG shard, native loader (threaded libjpeg)
    python_jpeg           JPEG shard, the python reader (PIL)
    eovc_jpeg_hires_full  512-short-side JPEG shard, native, full decode
    eovc_jpeg_hires_s2    the same at 1/2 scale in the DCT domain
    videodir_pooled       source video files (cv2), threaded get_batch
    videodir_per_record   the same, one get_frames call per clip

A path whose reader cannot be built or imported here (no ``jpeglib.h``
for the native loader, no PIL, no cv2) prints its line with ``"value":
null`` and the reason. The bench exits non-zero if no RAW path ran (the
python RAW reader needs nothing but numpy).

Knobs: ``EOV_DECODE_CLIPS`` (32), ``EOV_DECODE_K`` (8). Metric
``host_clip_decode_throughput``, clips/s on the host.
"""

from __future__ import annotations

import os
import statistics
import tempfile
import time

import numpy as np

from eov_tpu_torch.bench.common import emit

__all__ = ["main"]


class _Lines:
    """Prints one path's line; remembers the paths printed in this run."""

    def __init__(self):
        self.printed: list[str] = []

    def __call__(self, path: str, value, reader: str | None,
                 detail: dict) -> None:
        self.printed.append(path)
        emit({"metric": "host_clip_decode_throughput", "value": value,
              "unit": "clips/sec/host-core", "vs_baseline": None,
              "detail": {"path": path, "reader": reader, **detail}})


def _rate(read, n: int) -> tuple[float, float]:
    """(steady clips/s: median of 3 reads into the first read's buffer,
    clips/s of that first read)."""
    t0 = time.perf_counter()
    out = read(None)
    cold = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = read(out)
        times.append(time.perf_counter() - t0)
    return round(n / statistics.median(times), 2), round(n / cold, 2)


def _indices(recs, k: int) -> np.ndarray:
    return np.stack([np.linspace(0, r.num_frames - 1, k).astype(np.int32)
                     for r in recs])


def _shard_paths(line, td, ds, k, n_clips, base) -> list[str]:
    """Pack ``ds`` RAW and JPEG and measure the four shard paths."""
    from eov_tpu_torch.data.datasets import EovcVideoDataset
    from eov_tpu_torch.runtime.native import build_error
    from eov_tpu_torch.tools.pack_eovc import pack

    ran = []
    for codec in ("raw", "jpeg"):
        path = os.path.join(td, f"bench.{codec}.eovc")
        try:
            pack(ds, path, storage_short_side=256, codec=codec)
        except ImportError as e:  # JPEG packing needs PIL
            for native in (True, False):
                line(f"{'eovc' if native else 'python'}_{codec}", None,
                      None, {**base, "reason": f"cannot pack: {e}"})
            continue
        for native in (True, False):
            label = f"{'eovc' if native else 'python'}_{codec}"
            eds = EovcVideoDataset(path, prefer_native=native)
            if native and not eds.is_native:
                line(label, None, None, {**base, "reason":
                                          f"native loader: {build_error()}"})
                continue
            recs = eds.records[:n_clips]
            idx = _indices(recs, k)
            try:
                rate, cold = _rate(
                    lambda out: eds.get_batch(recs, idx, out=out), len(recs))
            except ImportError as e:  # the python JPEG reader needs PIL
                line(label, None, None, {**base, "reason": str(e)})
                continue
            line(label, rate, "native" if native else "python",
                  {**base, "coldbuf_clips_per_s": cold, "clips": len(recs)})
            ran.append(label)
    return ran


def _hires_paths(line, td, k, n_clips, base) -> None:
    """A 512-short-side JPEG shard decoded in full and at 1/2 scale."""
    from eov_tpu_torch.data.datasets import (EovcVideoDataset,
                                             SyntheticVideoDataset)
    from eov_tpu_torch.runtime.native import build_error, native_available
    from eov_tpu_torch.tools.pack_eovc import pack

    labels = (("eovc_jpeg_hires_full", 1), ("eovc_jpeg_hires_s2", 2))
    reason = None
    if not native_available():
        reason = f"native loader: {build_error()}"
    else:
        ds = SyntheticVideoDataset(
            n_classes=4, clips_per_class=(min(n_clips, 16) + 3) // 4, seed=0,
            height=512, width=640, min_frames=12, max_frames=16)
        path = os.path.join(td, "hi.jpeg.eovc")
        try:
            pack(ds, path, storage_short_side=512, codec="jpeg")
        except ImportError as e:
            reason = f"cannot pack: {e}"
    for label, denom in labels:
        if reason:
            line(label, None, None, {**base, "reason": reason})
            continue
        eds = EovcVideoDataset(path, jpeg_scale_denom=denom)
        idx = _indices(eds.records, k)
        rate, cold = _rate(
            lambda out: eds.get_batch(eds.records, idx, out=out),
            len(eds.records))
        line(label, rate, "native", {**base, "coldbuf_clips_per_s": cold,
                                      "clips": len(eds.records),
                                      "scale_denom": denom})


def _videodir_paths(line, td, k, n_clips, base) -> None:
    """Source video files through cv2: pooled and per record."""
    labels = ("videodir_pooled", "videodir_per_record")
    try:
        import cv2
    except ImportError as e:
        for label in labels:
            line(label, None, None, {**base, "reason": f"cv2: {e}"})
        return
    from eov_tpu_torch.data.datasets import VideoFileDataset

    vdir = os.path.join(td, "videos", "class_a")
    os.makedirs(vdir)
    rng = np.random.default_rng(0)
    for j in range(min(n_clips, 16)):
        wr = cv2.VideoWriter(os.path.join(vdir, f"v{j:03d}.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 10, (320, 256))
        if not wr.isOpened():
            for label in labels:
                line(label, None, None,
                      {**base, "reason": "cv2 cannot write mp4v"})
            return
        for _ in range(32):
            wr.write(rng.integers(0, 256, (256, 320, 3), dtype=np.uint8))
        wr.release()
    vds = VideoFileDataset(os.path.join(td, "videos"))
    recs = vds.records
    idx = _indices(recs, k)
    rate, cold = _rate(lambda out: vds.get_batch(recs, idx, out=out),
                       len(recs))
    line(labels[0], rate, "cv2", {**base, "coldbuf_clips_per_s": cold,
                                   "clips": len(recs)})

    def per_record(_):
        for r, i in zip(recs, idx):
            vds.get_frames(r, i)

    rate, _ = _rate(per_record, len(recs))
    line(labels[1], rate, "cv2", {**base, "clips": len(recs)})


def main() -> None:
    from eov_tpu_torch.data.datasets import SyntheticVideoDataset

    n_clips = int(os.environ.get("EOV_DECODE_CLIPS", "32"))
    k = int(os.environ.get("EOV_DECODE_K", "8"))
    base = {"k": k, "frame_hw": [256, 320]}
    ds = SyntheticVideoDataset(n_classes=8, clips_per_class=(n_clips + 7) // 8,
                               seed=0, height=256, width=320, min_frames=24,
                               max_frames=32)
    line = _Lines()
    with tempfile.TemporaryDirectory(prefix="eov_decode_") as td:
        ran = _shard_paths(line, td, ds, k, n_clips, base)
        if not {"eovc_raw", "python_raw"} & set(ran):
            raise SystemExit("decode bench: no RAW path ran")
        # The lever and onramp rows are best effort, as in the reference:
        # an error prints each of their missing lines with its reason.
        for group, labels in (
                (_hires_paths, ("eovc_jpeg_hires_full", "eovc_jpeg_hires_s2")),
                (_videodir_paths, ("videodir_pooled",
                                   "videodir_per_record"))):
            try:
                group(line, td, k, n_clips, base)
            except Exception as e:  # noqa: BLE001 — reported per line
                for label in labels:
                    if label not in line.printed:
                        line(label, None, None, {
                            **base, "reason": f"{type(e).__name__}: {e}"})


if __name__ == "__main__":
    main()
