"""Command line: ``python -m eov_tpu_torch.cli {extract,eval,train,test}``.

Counterpart of ``eov_tpu/cli.py``'s ``extract``, ``eval``, ``train`` and
``test``:

    extract — dataset -> clip features into a FeatureStore (resumable)
    eval    — seeded N-way K-shot episodes over a store, mean ± 95% CI;
              the last line printed is ``accuracy: MM.MM% +/- C.CC%``
    train   — TSN finetune of the backbone (train.py), one checkpoint per
              epoch under ``--out`` (utils/checkpoint.py); resumes from the
              newest ``step_N`` there, which takes precedence over the
              ``--params`` warm start
    test    — video-level top-1 of a train run's checkpoint (``--params
              <run dir>``, ``--select latest|best``); the last line printed
              is ``{"top1": ..., "n": ...}``

All run on the GPU (``--device cuda``, the default) and refuse to run
without one unless ``--device cpu`` is given. Stores are interchangeable
with the reference package's.

Not ported yet, and refused: ``train --multichip`` (multi-GPU) and
``train --val-class-split`` (class splits).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default="ucf101_600",
                   help="config preset (see eov_tpu_torch/config.py)")
    p.add_argument("--store", required=True, help="feature store directory")
    p.add_argument("--metrics", default=None, help="metrics.jsonl path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")


def _load_dataset(args):
    from eov_tpu_torch.data.datasets import SyntheticVideoDataset

    if args.dataset != "synthetic":
        raise SystemExit(f"dataset {args.dataset!r} is not ported yet "
                         "(only 'synthetic')")
    return SyntheticVideoDataset(
        n_classes=args.synthetic_classes,
        clips_per_class=args.synthetic_clips,
        height=args.synthetic_height, width=args.synthetic_width,
        seed=args.seed,
    )


def _load_weights(args, arch: str):
    from eov_tpu_torch.models import resnet

    if args.params:
        try:
            return resnet.load_state_dict(args.params, arch)
        except (ValueError, KeyError) as e:
            raise SystemExit(f"--params {args.params} does not load as "
                             f"arch {arch}: {e}") from None
    print(
        "warning: no --params given; using RANDOM ImageNet-free weights "
        "(fixture mode — accuracy will not match pretrained parity)",
        file=sys.stderr,
    )
    return resnet.random_state_dict(arch, seed=args.seed)


def _fused_stages(spec: str):
    if spec == "auto":
        return "auto"
    try:
        return tuple(int(v) for v in spec.replace("none", "").split(",")
                     if v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"invalid --fused-stages {spec!r}: 'auto', 'none' or a comma "
            "list like '1' / '1,2'") from None


def cmd_extract(args) -> int:
    from eov_tpu_torch.config import get_preset, resolved_dict
    from eov_tpu_torch.data.store import FeatureStore
    from eov_tpu_torch.extract import extract_features
    from eov_tpu_torch.utils.device import resolve_device
    from eov_tpu_torch.utils.metrics import MetricsWriter

    device = resolve_device(args.device)
    cfg = get_preset(args.preset).extract
    overrides = {k: v for k, v in (
        ("arch", args.arch), ("num_segments", args.num_segments),
        ("batch_clips", args.batch), ("fused_stages", args.fused_stages),
        ("scale_size", args.scale_size), ("crop_size", args.crop_size),
    ) if v is not None}
    cfg = dataclasses.replace(cfg, **overrides)
    dataset = _load_dataset(args)
    weights = _load_weights(args, cfg.arch)
    try:
        store = FeatureStore(args.store, class_names=list(dataset.class_names),
                             dtype=args.store_dtype, quant=None)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    metrics = MetricsWriter(args.metrics)
    metrics.write("config", command="extract", config=resolved_dict(cfg),
                  device=str(device))
    try:
        stats = extract_features(dataset, weights, store, cfg, metrics,
                                 device=device)
    finally:
        metrics.close()
    print(json.dumps(stats))
    return 0


def cmd_eval(args) -> int:
    import numpy as np

    from eov_tpu_torch.config import get_preset, resolved_dict
    from eov_tpu_torch.data.store import FeatureStore
    from eov_tpu_torch.eval import evaluate
    from eov_tpu_torch.utils.device import resolve_device
    from eov_tpu_torch.utils.metrics import MetricsWriter

    device = resolve_device(args.device)
    preset = get_preset(args.preset)
    if preset.embodied:
        raise SystemExit(f"preset {preset.name} needs embodied eval, which "
                         "is not ported yet")
    overrides = {f: getattr(args, f) for f in (
        "n_way", "k_shot", "n_query", "n_episodes", "metric", "fusion",
        "seed") if getattr(args, f) is not None}
    cfg = dataclasses.replace(preset.eval, **overrides)
    table = FeatureStore(args.store).to_table(device)
    metrics = MetricsWriter(args.metrics)
    metrics.write("config", command="eval", config=resolved_dict(cfg),
                  device=str(device))
    res = evaluate(table, cfg)
    metrics.write("eval_result", mean_acc=res.mean_acc, ci95=res.ci95,
                  n_episodes=len(res.per_episode))
    metrics.close()
    if args.per_episode_out:
        # Same format as the reference's, for paired comparisons
        # (eov_tpu/tools/compare_eval.py reads either package's file).
        doc = {
            "config": resolved_dict(cfg),
            "store": args.store,
            "counts": [int(c) for c in np.asarray(table.counts.cpu())],
            "mean_acc": res.mean_acc,
            "ci95": res.ci95,
            "per_episode": [float(a) for a in res.per_episode],
        }
        with open(args.per_episode_out, "w") as f:
            json.dump(doc, f)
        print(f"per-episode accuracies -> {args.per_episode_out}")
    print(res)  # "accuracy: MM.MM% +/- C.CC%"
    return 0


def _resolve_ckpt_dir(path: str, select: str = "latest") -> str:
    """A train-run directory -> one epoch's checkpoint dir: the newest
    ``step_N`` (``latest``) or best.json's meta-val winner (``best``)."""
    from eov_tpu_torch.utils.checkpoint import latest_step_dir

    if not os.path.isdir(path):
        return path
    if select == "best":
        bj = os.path.join(path, "best.json")
        if not os.path.exists(bj):
            raise SystemExit(f"--select best: no best.json under {path} — "
                             "the run recorded no meta-val accuracy")
        with open(bj) as f:
            return os.path.join(path, json.load(f)["dir"])
    return latest_step_dir(path) or path


def _donor_state_dict(path: str) -> dict:
    """Warm-start weights: a torchvision .pth/.pt/.npz state_dict, or a
    train run (its newest checkpoint's model)."""
    import numpy as np
    import torch

    from eov_tpu_torch.utils.checkpoint import read_state

    if os.path.isdir(path):
        return read_state(_resolve_ckpt_dir(path))["model"]
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    if path.endswith((".pth", ".pt")):
        return torch.load(path, map_location="cpu", weights_only=True)
    raise SystemExit(f"--params must be a train-run dir, .pth, .pt or "
                     f".npz, got {path}")


def warm_start(state, path: str, num_classes: int) -> None:
    """Load a donor's weights into a fresh train state. A head of another
    width is dropped (the fc stays fresh); missing, stray or differently
    shaped modules are refused — a checkpoint of another arch would
    otherwise be silently mixed in."""
    donor = {k: v for k, v in _donor_state_dict(path).items()
             if not k.endswith("num_batches_tracked")}
    fc = donor.get("fc.weight")
    if fc is not None and fc.shape[0] != num_classes:
        print(f"--params head is {fc.shape[0]}-way; training {num_classes} "
              "classes — keeping a fresh fc", file=sys.stderr)
        donor.pop("fc.weight")
        donor.pop("fc.bias", None)
    own = state.model.state_dict()
    missing = sorted(k for k in own if k not in donor
                     and not k.startswith("fc."))
    if missing:
        raise SystemExit(f"--params is missing {len(missing)} backbone "
                         f"tensors, e.g. {missing[:4]} — wrong --arch or "
                         "checkpoint?")
    extra = sorted(k for k in donor if k not in own)
    if extra:
        raise SystemExit(f"--params carries {len(extra)} tensors that the "
                         f"arch does not have, e.g. {extra[:4]} — wrong "
                         "--arch or checkpoint?")
    bad = [k for k in donor if tuple(donor[k].shape) != tuple(own[k].shape)]
    if bad:
        raise SystemExit(
            f"--params does not match the arch: {len(bad)} tensors differ "
            "in shape, e.g. " + ", ".join(
                f"{k} {tuple(donor[k].shape)} vs {tuple(own[k].shape)}"
                for k in bad[:3]) + " — wrong --arch or checkpoint?")
    state.model.load_state_dict({**own, **donor})


def run_training(cfg, dataset, *, device, epochs: int, out: str | None = None,
                 params: str | None = None, metrics_path: str | None = None,
                 val_dataset=None, val_n_way: int = 5,
                 val_episodes: int = 120, val_segments: int = 8) -> dict:
    """The train command's body: warm start, resume, epochs, a checkpoint
    per epoch, and with ``val_dataset`` a meta-val one-shot score per
    epoch with the best recorded in ``out/best.json``. Returns the last
    epoch's metrics."""
    from eov_tpu_torch import train as tr
    from eov_tpu_torch.config import resolved_dict
    from eov_tpu_torch.utils.checkpoint import (latest_step_dir, load_state,
                                                save_state)
    from eov_tpu_torch.utils.metrics import MetricsWriter

    metrics = MetricsWriter(metrics_path)
    metrics.write("config", command="train", config=resolved_dict(cfg),
                  device=str(device))
    state = tr.create_train_state(cfg, device)
    if params:
        warm_start(state, params, cfg.num_classes)
    start_epoch = 0
    last = latest_step_dir(out) if out else None
    if last:  # resume takes precedence over the warm start
        load_state(last, state)
        start_epoch = int(os.path.basename(last).split("_")[1]) + 1
        print(f"resumed from {last} (epoch {start_epoch})")
    step_fn = tr.make_train_step(cfg, device)
    best = None  # (val_acc, ci95, epoch)
    best_path = os.path.join(out, "best.json") if out else None
    if best_path and os.path.exists(best_path):
        with open(best_path) as f:
            doc = json.load(f)
        best = (doc["val_acc"], doc["ci95"], doc["epoch"])
    m: dict = {}
    for epoch in range(start_epoch, epochs):
        state, m = tr.train_epoch(state, step_fn, cfg, dataset, epoch=epoch)
        metrics.write("epoch", epoch=epoch, **m)
        print(f"epoch {epoch}: {m}")
        if out:
            save_state(os.path.join(out, f"step_{epoch}"), state)
        if val_dataset is None:
            continue
        res = tr.one_shot_validate(state, cfg, val_dataset, n_way=val_n_way,
                                   n_episodes=val_episodes,
                                   num_segments=val_segments, seed=cfg.seed)
        metrics.write("val", epoch=epoch, val_acc=res.mean_acc,
                      ci95=res.ci95, n_episodes=val_episodes)
        print(f"epoch {epoch} meta-val one-shot {res}")
        if best is None or res.mean_acc > best[0]:
            best = (res.mean_acc, res.ci95, epoch)
            if best_path:
                tmp = best_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({"epoch": epoch, "val_acc": res.mean_acc,
                               "ci95": res.ci95, "dir": f"step_{epoch}"}, f)
                os.replace(tmp, best_path)
    metrics.close()
    if out:
        print(f"saved checkpoints under: {out}")
        if best is not None:
            print(f"best meta-val epoch {best[2]}: {best[0] * 100:.2f}% +/- "
                  f"{best[1] * 100:.2f}% (best.json; use --select best)")
    return m


def _train_config(args, num_classes: int, num_segments: int):
    """The reference CLI's TrainConfig: flags over its defaults (K 3 for
    train, 8 for test; 8 clips per step)."""
    from eov_tpu_torch.train import TrainConfig

    return TrainConfig(
        num_classes=num_classes, arch=args.arch or "resnet50",
        num_segments=args.num_segments or num_segments,
        batch_clips=args.batch or 8, lr=getattr(args, "lr", None) or 0.001,
        scale_size=args.scale_size or 256, crop_size=args.crop_size or 224,
        seed=args.seed)


def cmd_train(args) -> int:
    from eov_tpu_torch.utils.device import resolve_device

    if args.multichip:
        raise SystemExit("--multichip: multi-GPU training is not ported yet")
    if args.val_class_split:
        raise SystemExit("--val-class-split: class splits are not ported "
                         "yet")
    device = resolve_device(args.device)
    dataset = _load_dataset(args)
    cfg = _train_config(args, len(dataset.class_names), num_segments=3)
    run_training(cfg, dataset, device=device, epochs=args.epochs,
                 out=args.out, params=args.params, metrics_path=args.metrics)
    return 0


def cmd_test(args) -> int:
    """Video-level classification accuracy of a finetuned checkpoint."""
    from eov_tpu_torch import train as tr
    from eov_tpu_torch.utils.checkpoint import load_state
    from eov_tpu_torch.utils.device import resolve_device
    from eov_tpu_torch.utils.metrics import MetricsWriter

    device = resolve_device(args.device)
    dataset = _load_dataset(args)
    cfg = _train_config(args, len(dataset.class_names), num_segments=8)
    state = tr.create_train_state(cfg, device)
    if args.params:
        if args.params.endswith((".pth", ".pt", ".npz")):
            # A backbone has no finetuned head: scoring it with a random fc
            # is meaningless. test consumes train-run checkpoints.
            raise SystemExit(
                "test scores a finetuned checkpoint (a train-run dir, e.g. "
                "--params <run>/ --select best); to finetune from "
                f"{os.path.basename(args.params)} first, use `train "
                "--params`")
        load_state(_resolve_ckpt_dir(args.params, args.select), state)
    m = tr.evaluate_classifier(state, cfg, dataset)
    MetricsWriter(args.metrics).write("test_result", **m)
    print(json.dumps(m))
    return 0


def _add_train_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", default="synthetic", choices=["synthetic"])
    p.add_argument("--synthetic-classes", type=int, default=10)
    p.add_argument("--synthetic-clips", type=int, default=8)
    p.add_argument("--synthetic-height", type=int, default=128)
    p.add_argument("--synthetic-width", type=int, default=160)
    p.add_argument("--params", default=None,
                   help="train-run dir, or a torchvision .pth/.pt/.npz")
    p.add_argument("--arch", default=None,
                   help="backbone arch (resnet18/34/50/101/152)")
    p.add_argument("--batch", type=int, default=None,
                   help="clips per step (default 8)")
    p.add_argument("--num-segments", type=int, default=None)
    p.add_argument("--scale-size", type=int, default=None)
    p.add_argument("--crop-size", type=int, default=None)
    p.add_argument("--metrics", default=None, help="metrics.jsonl path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("eov_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser("extract", help="dataset -> clip feature store")
    _add_common(ex)
    ex.add_argument("--dataset", default="synthetic", choices=["synthetic"])
    ex.add_argument("--synthetic-classes", type=int, default=10)
    ex.add_argument("--synthetic-clips", type=int, default=8)
    ex.add_argument("--synthetic-height", type=int, default=128)
    ex.add_argument("--synthetic-width", type=int, default=160)
    ex.add_argument("--params", default=None,
                    help="torchvision .pth/.pt or .npz state_dict")
    ex.add_argument("--arch", default=None,
                    help="backbone arch (resnet18/34/50/101/152)")
    ex.add_argument("--num-segments", type=int, default=None)
    ex.add_argument("--batch", type=int, default=None,
                    help="clips per device batch (default: the preset's)")
    ex.add_argument("--scale-size", type=int, default=None,
                    help="eval short-side scale (default: the preset's)")
    ex.add_argument("--crop-size", type=int, default=None,
                    help="eval center crop (default: the preset's)")
    ex.add_argument("--fused-stages", type=_fused_stages, default=None,
                    metavar="SPEC",
                    help="'auto' (default), 'none', or a list like '1,2'")
    ex.add_argument("--store-dtype", default=None,
                    choices=("float32", "float16"))
    ex.set_defaults(fn=cmd_extract)

    ev = sub.add_parser("eval", help="episodic one-shot eval over a store")
    _add_common(ev)
    ev.set_defaults(seed=None)
    ev.add_argument("--n-way", type=int, dest="n_way")
    ev.add_argument("--k-shot", type=int, dest="k_shot")
    ev.add_argument("--n-query", type=int, dest="n_query")
    ev.add_argument("--n-episodes", type=int, dest="n_episodes")
    ev.add_argument("--metric", choices=["cosine", "euclidean"])
    ev.add_argument("--fusion", choices=["max", "mean"])
    ev.add_argument("--per-episode-out", dest="per_episode_out",
                    default=None, metavar="FILE")
    ev.set_defaults(fn=cmd_eval)

    tr = sub.add_parser("train", help="TSN finetune of the backbone")
    _add_train_common(tr)
    tr.add_argument("--epochs", type=int, default=1)
    tr.add_argument("--lr", type=float, default=None)
    tr.add_argument("--out", default=None,
                    help="run dir: step_N checkpoints, best.json, resume")
    tr.add_argument("--multichip", action="store_true",
                    help="not ported yet (refused)")
    tr.add_argument("--val-class-split", dest="val_class_split",
                    default=None, metavar="JSON[:part]",
                    help="not ported yet (refused)")
    tr.set_defaults(fn=cmd_train)

    te = sub.add_parser("test", help="top-1 of a train run's checkpoint")
    _add_train_common(te)
    te.add_argument("--select", choices=("latest", "best"), default="latest",
                    help="newest epoch of the run dir, or best.json's")
    te.set_defaults(fn=cmd_test)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
