"""Accuracy-parity harness: the port against an independent PyTorch
ResNet-50 pipeline.

Counterpart of ``eov_tpu/tools/parity_harness.py``. Point it at a
torchvision ``resnet50`` state_dict (``.pth``/``.npz``) and a frame-folder
dataset, and it runs both pipelines on the same decoded clips:

  A (reference semantics): PIL resize to the short side, center crop,
    normalize -> the hand-written ``nn.Conv2d`` ResNet-50 of
    ``tools/torch_ref.py`` in f32 on the CPU -> TSN mean
  B (the port): its extraction (``extract.make_feature_fn``: kernel 1,
    the folded ResNet-50 with stage 1 on kernel 2 on a GPU; with
    ``--quant int8`` the int8 forward, stage 1 on kernel 7) on
    ``--device`` (default ``cuda``) -> TSN mean

then scores the same seeded episodes over both feature tables and reports
the per-clip feature cosine and the episode-accuracy delta against the
0.5% budget, under the reference's report keys. A torchvision state_dict
loads straight into the port (``models/resnet.py``), so the reference's
``port_torch`` step has no counterpart. Without ``--params``, or without
``--root``/``--split``, it self-checks: shared seeded weights from a
``torch.Generator`` (``models.resnet.random_state_dict``) and/or the
synthetic fixture clips.

Run: python -m eov_tpu_torch.tools.parity_harness [--params resnet50.pth]
         [--root FRAMES --split list.txt] [--n-episodes 600]
         [--quant int8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from eov_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["run", "main"]

BUDGET = 0.005  # the north star's accuracy bar: |A - B| <= 0.5 points


def _pil_preprocess(frames_u8: np.ndarray, scale: int, crop: int) -> np.ndarray:
    """The reference transform chain through PIL (imported here: the GPU
    machine may not have it): [K, H, W, 3] u8 -> [K, crop, crop, 3] f32."""
    from PIL import Image

    out = []
    for fr in frames_u8:
        im = Image.fromarray(fr)
        w, h = im.size
        if w <= h:
            ow, oh = (w, h) if w == scale else (scale, int(scale * h / w))
        else:
            ow, oh = (w, h) if h == scale else (int(scale * w / h), scale)
        im = im.resize((ow, oh), Image.BILINEAR)
        left, top = (ow - crop) // 2, (oh - crop) // 2
        im = im.crop((left, top, left + crop, top + crop))
        out.append(np.asarray(im, np.float32) / 255.0)
    return (np.stack(out) - IMAGENET_MEAN) / IMAGENET_STD


def _torch_features(sd: dict, clips_u8: np.ndarray, scale: int,
                    crop: int) -> np.ndarray:
    """Pipeline A: [B, K, H, W, 3] u8 -> [B, 2048] f32 on the CPU."""
    from eov_tpu_torch.tools.torch_ref import TorchResNet50

    model = TorchResNet50()
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in sd.items()}, strict=False)
    model.eval()
    feats = []
    with torch.no_grad():
        for clip in clips_u8:
            x = _pil_preprocess(clip, scale, crop)
            t = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
            feats.append(model(t).mean(dim=0).numpy())
    return np.stack(feats)


def _port_features(sd: dict, clips_u8: np.ndarray, scale: int, crop: int,
                   dtype: str, quant: str | None, device: str) -> np.ndarray:
    """Pipeline B: the port's feature program on ``device``."""
    from eov_tpu_torch.extract import ExtractConfig, make_feature_fn

    cfg = ExtractConfig(num_segments=clips_u8.shape[1], scale_size=scale,
                        crop_size=crop, compute_dtype=dtype, quant=quant)
    fn = make_feature_fn(sd, cfg, device)
    return fn(torch.from_numpy(clips_u8)).cpu().numpy()


def _weights(path: str | None, seed: int) -> dict:
    """A torchvision ResNet-50 state_dict (numpy values, counters dropped),
    or seeded random weights."""
    from eov_tpu_torch.models.resnet import load_state_dict, random_state_dict

    if path:
        sd = load_state_dict(path, "resnet50")
    else:
        sd = random_state_dict("resnet50", seed=seed)
        print("note: no --params; shared RANDOM weights (self-check mode)",
              file=sys.stderr)
    return {k: np.asarray(v) for k, v in sd.items()
            if "num_batches_tracked" not in k}


def run(args) -> dict:
    from eov_tpu_torch.data.datasets import SyntheticVideoDataset
    from eov_tpu_torch.data.segments import center_indices_np
    from eov_tpu_torch.eval import EvalConfig, FeatureTable, evaluate

    sd = _weights(args.params, args.seed)
    if args.root and args.split:
        from eov_tpu_torch.data.datasets import (FrameFolderDataset,
                                                 load_split_txt)

        split = load_split_txt(args.split)
        names = sorted({str(lab) for _, _, lab in split})
        ds = FrameFolderDataset(args.root, split, names)
    else:
        ds = SyntheticVideoDataset(n_classes=args.classes,
                                   clips_per_class=args.clips_per_class,
                                   seed=args.seed, height=120, width=160)

    k = args.num_segments
    clips = np.stack([ds.get_frames(r, center_indices_np(r.num_frames, k))
                      for r in ds.records])
    labels = [r.label for r in ds.records]
    quant = getattr(args, "quant", None)
    quant = None if quant == "off" else quant
    fa = _torch_features(sd, clips, args.scale, args.crop)
    fb = _port_features(sd, clips, args.scale, args.crop, args.dtype, quant,
                        getattr(args, "device", "cuda"))
    na = fa / np.linalg.norm(fa, axis=1, keepdims=True)
    nb = fb / np.linalg.norm(fb, axis=1, keepdims=True)
    cos = np.sum(na * nb, axis=1)

    n_classes = len(ds.class_names)
    per_class = int(max(np.bincount(labels, minlength=n_classes)))

    def table(f):
        feats = np.zeros((n_classes, per_class, f.shape[1]), np.float32)
        counts = np.zeros((n_classes,), np.int64)
        for feat, lab in zip(f, labels):
            feats[lab, counts[lab]] = feat
            counts[lab] += 1
        return FeatureTable(torch.from_numpy(feats), torch.from_numpy(counts))

    cfg = EvalConfig(n_way=min(5, n_classes), n_episodes=args.n_episodes,
                     seed=args.seed)
    ra, rb = evaluate(table(fa), cfg), evaluate(table(fb), cfg)
    delta = abs(ra.mean_acc - rb.mean_acc)
    return {
        "clips": int(len(clips)),
        "feature_cosine_min": float(cos.min()),
        "feature_cosine_mean": float(cos.mean()),
        "torch_acc": ra.mean_acc,
        "torch_ci95": ra.ci95,
        "eov_acc": rb.mean_acc,
        "eov_ci95": rb.ci95,
        "acc_delta_abs": delta,
        "budget": BUDGET,
        "within_budget": delta <= BUDGET,
        "mode": "real" if args.params else "self_check_random_weights",
        "quant": quant,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("parity_harness", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", default=None,
                    help="torchvision resnet50 state_dict (.pth or .npz)")
    ap.add_argument("--root", default=None, help="frame-folder dataset root")
    ap.add_argument("--split", default=None, help="TSN split txt")
    ap.add_argument("--classes", type=int, default=6)
    ap.add_argument("--clips-per-class", type=int, default=4)
    ap.add_argument("--num-segments", type=int, default=8)
    ap.add_argument("--scale", type=int, default=256)
    ap.add_argument("--crop", type=int, default=224)
    ap.add_argument("--dtype", default="float32",
                    help="the port's compute dtype (float32 for parity runs, "
                         "bfloat16 to measure the production path's delta)")
    ap.add_argument("--quant", default=None, choices=("off", "int8"),
                    help="run pipeline B through the int8 forward (extract "
                         "--quant int8)")
    ap.add_argument("--device", default="cuda",
                    help="pipeline B's device: cuda (default) or cpu")
    ap.add_argument("--n-episodes", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run(args)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
