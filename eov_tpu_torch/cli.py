"""Command line: ``python -m eov_tpu_torch.cli {extract,eval}``.

Counterpart of ``eov_tpu/cli.py``'s ``extract`` and ``eval``:

    extract — dataset -> clip features into a FeatureStore (resumable)
    eval    — seeded N-way K-shot episodes over a store, mean ± 95% CI;
              the last line printed is ``accuracy: MM.MM% +/- C.CC%``

Both run on the GPU (``--device cuda``, the default) and refuse to run
without one unless ``--device cpu`` is given. Stores are interchangeable
with the reference package's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
