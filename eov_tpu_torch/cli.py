"""Command line: ``python -m eov_tpu_torch.cli {extract,eval,classify,
episode,store-info,train,test,fixtures,presets,bench}``.

Counterpart of ``eov_tpu/cli.py``'s commands of the same names:

    extract    — dataset -> clip features into a FeatureStore (resumable);
                 ``--quant int8`` extracts with the int8 forward and records
                 its calibration (``--quant-calib synthetic|dataset``) in
                 the store; ``--pallas-pool on|fused`` runs the stem pool
                 through kernel 6, or inside the stage-1 stack (kernel 5);
                 ``--fused-group N`` is accepted and ignored (a TPU grid
                 knob of the reference, bit-identical for every N)
    eval       — seeded N-way K-shot episodes over a store, mean ± 95% CI;
                 ``--embodied --virtual-store S`` (or the
                 ``kinetics_embodied`` preset) adds S's virtual clips to
                 each class's support; ``--matcher auto|xla|pallas``
                 (kernel 3 on the GPU | the plain version | kernel 3,
                 refused on the CPU); ``--per-episode-out FILE`` writes the
                 per-episode accuracies for ``tools/compare_eval.py``; the
                 last line printed is ``accuracy: MM.MM% +/- C.CC%``
    classify   — featurize new clips and assign each the support store's
                 best class (one JSON line per clip); queries go through
                 the store's recorded precision and int8 calibration
    episode    — one N-way 1-shot episode from raw clips, end to end
    store-info — a store's merged summary as one JSON line
    train      — TSN finetune of the backbone (train.py), one checkpoint per
                 epoch under ``--out`` (utils/checkpoint.py); resumes from
                 the newest ``step_N`` there, which takes precedence over
                 the ``--params`` warm start
    test       — video-level top-1 of a train run's checkpoint (``--params
                 <run dir>``, ``--select latest|best``); the last line
                 printed is ``{"top1": ..., "n": ...}``
    fixtures   — write the synthetic dataset as JPEG frame folders and a
                 ``split.json`` under ``--root`` (needs PIL)
    presets    — list the config presets (``--verbose``: their configs)
    bench      — the headline feature bench (``bench/features.py``, one
                 JSON line; ``EOV_BENCH_*`` knobs)

``extract``, ``classify`` and ``episode`` take ``--params`` as a
torchvision .pth/.pt/.npz state_dict or a train-run directory (the
checkpoint ``--select latest|best`` names on extract and classify, the
newest on episode), as the reference's do.

Every command that reads clips takes ``--dataset synthetic|framedir|
videodir|eovc`` with ``--root``, ``--split`` (TSN txt or split json),
``--split-name``, ``--class-split JSON[:part]`` (a class-level one-shot
split, e.g. ``eov_tpu_torch/splits/ucf101_oneshot.json:test``) and, for
EOVC JPEG shards, ``--jpeg-scale-denom``. ``train --val-class-split``
scores each epoch on the meta-val classes and records the best in
``best.json``.

``train --metrics`` writes each epoch's ``utils.trace`` report (seconds per
span, counters, device gaps) in its ``epoch`` events, ``extract --metrics``
the pass's in ``extract_done``.

Every command takes ``--trace DIR`` (a ``torch.profiler`` trace of the
command and its ``trace_meta.json``, read by ``tools/profile_summary.py``;
the program's spans appear in it as ``eov.<span>``),
``--debug-nans`` (every output — features, scores, the train loss and
gradients — is checked finite and a NaN or infinity raises, naming the
tensor; ``train`` also runs under autograd's anomaly detection) and
``--platform cpu|cuda|gpu`` (sets ``--device``; ``tpu`` is refused).

extract, eval, classify, episode, train, test and bench run on the GPU
(``--device cuda``, the default) and refuse to run without one unless
``--device cpu`` is given. Stores are interchangeable with the reference
package's.

``extract``, ``eval`` and ``train`` take ``--multichip``: one process per
GPU under torchrun, e.g. ``python -m torch.distributed.run --standalone
--nproc_per_node 4 -m eov_tpu_torch.cli extract --multichip ...``, over
the preset's ('data', 'frame') mesh (``parallel/``): extract shards the
clips (each data row writes its own namespace of the one store), eval the
episodes, train the global batch. Without a launcher ``--multichip`` runs
a world of 1 on one visible GPU (or the CPU) and refuses to run with
several visible GPUs, naming the torchrun command (a single process would
leave all but one idle).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _add_global(p: argparse.ArgumentParser) -> None:
    """The flags every command takes."""
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the command under "
                        "DIR (tools/profile_summary.py reads it)")
    p.add_argument("--debug-nans", action="store_true", dest="debug_nans",
                   help="check every output finite; a NaN or inf raises")
    p.add_argument("--platform", default=None, metavar="{cpu,cuda,gpu}",
                   help="device to run on (sets --device)")


def _platform_device(args) -> None:
    """``--platform`` onto ``--device``; anything but cpu/cuda/gpu is
    refused."""
    plat = args.platform
    if plat is None:
        return
    if plat == "tpu":
        raise SystemExit("--platform tpu: eov_tpu_torch runs on an NVIDIA "
                         "GPU (cuda) or the CPU; the TPU program is the "
                         "eov_tpu package")
    if plat not in ("cpu", "cuda", "gpu"):
        raise SystemExit(f"--platform {plat!r}: expected cpu, cuda or gpu")
    args.device = "cuda" if plat == "gpu" else plat


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default="ucf101_600",
                   help="config preset (see eov_tpu_torch/config.py)")
    p.add_argument("--store", required=True, help="feature store directory")
    p.add_argument("--metrics", default=None, help="metrics.jsonl path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")


def _class_split_part(spec: str) -> list[str]:
    """The classes of a ``--class-split JSON[:part]`` spec (part defaults
    to 'test')."""
    from eov_tpu_torch.data import class_splits as cs

    path, _, part = spec.partition(":")
    return cs.load_class_split(path)["class_splits"][part or "test"]


def _load_dataset(args):
    from eov_tpu_torch.data import datasets

    def class_filtered(ds):
        spec = getattr(args, "class_split", None)
        if not spec:
            return ds
        from eov_tpu_torch.data import class_splits as cs

        return cs.filter_dataset_by_classes(ds, _class_split_part(spec))

    if args.dataset == "synthetic":
        return class_filtered(datasets.SyntheticVideoDataset(
            n_classes=args.synthetic_classes,
            clips_per_class=args.synthetic_clips,
            height=args.synthetic_height, width=args.synthetic_width,
            seed=args.seed, virtual=getattr(args, "synthetic_virtual", False),
        ))
    if args.dataset == "eovc":
        if not args.root:
            raise SystemExit("--root (file or shard dir) required for eovc")
        names = None
        if args.split and args.split.endswith(".json"):
            names = datasets.load_split_json(args.split)["class_names"]
        return class_filtered(datasets.EovcVideoDataset(
            args.root, class_names=names,
            jpeg_scale_denom=args.jpeg_scale_denom))
    if args.dataset == "videodir":
        # root/<class>/<video>, or --split lists of (relative path,
        # num_frames, label) where num_frames <= 0 probes the container.
        if not args.root:
            raise SystemExit("--root required for videodir")
        split = names = only = None
        if args.split:
            if args.split.endswith(".json"):
                meta = datasets.load_split_json(args.split)
                split = meta["splits"][args.split_name]
                names = meta["class_names"]
            else:
                split = datasets.load_split_txt(args.split)
        elif getattr(args, "class_split", None):
            # Discovery opens every container to count its frames: restrict
            # it to the split's classes up front.
            only = _class_split_part(args.class_split)
        return class_filtered(datasets.VideoFileDataset(
            args.root, split, names, only_classes=only))
    if args.dataset == "framedir":
        if not (args.root and args.split):
            raise SystemExit("--root and --split required for framedir")
        if args.split.endswith(".json"):
            meta = datasets.load_split_json(args.split)
            split = meta["splits"][args.split_name]
            names = meta["class_names"]
        else:
            split = datasets.load_split_txt(args.split)
            names = [str(i) for i in range(max(s[2] for s in split) + 1)]
        if getattr(args, "class_split", None):
            from eov_tpu_torch.data import class_splits as cs

            split, names = cs.filter_split_by_classes(
                split, names, _class_split_part(args.class_split))
        return datasets.FrameFolderDataset(args.root, split, names)
    raise SystemExit(f"unknown dataset {args.dataset}")


def _load_weights(args, arch: str):
    """The backbone weights of ``--params``: a torchvision .pth/.pt/.npz
    state_dict, or a train-run directory resolved by ``--select`` (the
    checkpoint's model; a finetuned fc of any width is ignored)."""
    from eov_tpu_torch.models import resnet
    from eov_tpu_torch.utils.checkpoint import read_state

    if args.params:
        try:
            if os.path.isdir(args.params):
                ckpt = _resolve_ckpt_dir(args.params,
                                         getattr(args, "select", "latest"))
                return resnet.check_state_dict(read_state(ckpt)["model"],
                                               arch)
            return resnet.load_state_dict(args.params, arch)
        except (ValueError, KeyError, FileNotFoundError) as e:
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


def _positive_int(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"expected a positive int, got {s}")
    return v


def _extract_config(args):
    """The preset's ExtractConfig with the command's overrides."""
    from eov_tpu_torch.config import get_preset

    cfg = get_preset(args.preset).extract
    overrides = {k: v for k, v in (
        ("arch", args.arch), ("num_segments", args.num_segments),
        ("batch_clips", args.batch),
        ("fused_stages", getattr(args, "fused_stages", None)),
        ("scale_size", args.scale_size), ("crop_size", args.crop_size),
    ) if v is not None}
    if getattr(args, "fused_group", None) is not None:
        overrides["fused_group"] = args.fused_group
    quant = getattr(args, "quant", None)
    if quant is not None:
        overrides["quant"] = None if quant == "off" else quant
    pool = getattr(args, "pallas_pool", None)
    if pool is not None:
        overrides["pallas_pool"] = {"off": False, "on": True,
                                    "fused": "fused"}[pool]
    try:  # the config's refusals, before any dataset or store is touched
        return dataclasses.replace(cfg, **overrides)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def _multichip(args, n_frame: int = 1):
    """``--multichip``: (the ('data', 'frame') mesh over the world, this
    rank's device). Under a launcher (torchrun) the process group comes up
    from its environment; without one, a world of 1 on one visible GPU (or
    the CPU) — several visible GPUs and no launcher are refused."""
    import torch

    from eov_tpu_torch.parallel import distributed as pdist
    from eov_tpu_torch.utils.device import resolve_device

    if not pdist.launcher_env_detected():
        n_gpu = (torch.cuda.device_count()
                 if torch.device(args.device).type == "cuda" else 0)
        if n_gpu > 1:
            raise SystemExit(
                f"--multichip sees {n_gpu} GPUs but no launcher: one "
                "process would leave all but one GPU idle. Run one process "
                "per GPU: python -m torch.distributed.run --standalone "
                f"--nproc_per_node {n_gpu} -m eov_tpu_torch.cli {args.cmd} "
                "--multichip ...")
        print(f"--multichip without a launcher: a world of 1 on "
              f"{args.device}", file=sys.stderr)
    device = resolve_device(pdist.local_device(args.device))
    pdist.initialize(device=device)
    try:
        return pdist.global_mesh(n_frame=n_frame), device
    except ValueError as e:
        raise SystemExit(f"--multichip: {e}") from None


def cmd_extract(args) -> int:
    from eov_tpu_torch.config import get_preset, resolved_dict
    from eov_tpu_torch.data.store import FeatureStore
    from eov_tpu_torch.extract import extract_features, quant_calibration
    from eov_tpu_torch.parallel import distributed as pdist
    from eov_tpu_torch.utils.device import resolve_device
    from eov_tpu_torch.utils.metrics import MetricsWriter

    mesh = None
    if args.multichip:
        mesh, device = _multichip(args, get_preset(args.preset).n_frame)
    else:
        device = resolve_device(args.device)
    cfg = _extract_config(args)
    if args.quant_calib is not None:
        if not cfg.quant:
            raise SystemExit("--quant-calib only applies with --quant int8")
        cfg = dataclasses.replace(cfg, quant_calib=args.quant_calib)
    if mesh is not None:
        # The global batch rounds to a multiple of the data size; every
        # step runs at the full local batch.
        batch = max(cfg.batch_clips, mesh.n_data)
        cfg = dataclasses.replace(cfg, batch_clips=batch - batch % mesh.n_data,
                                  pad_batches=True)
    dataset = _load_dataset(args)
    weights = _load_weights(args, cfg.arch)
    act_max = None
    if cfg.quant:
        # The int8 scales are computed once (on rank 0 under --multichip,
        # then broadcast) and recorded in the store, so classify featurizes
        # queries with this exact program.
        if pdist.rank() == 0:
            act_max = quant_calibration(
                weights, cfg,
                dataset if cfg.quant_calib == "dataset" else None, device)
        act_max = pdist.broadcast_object(act_max)
    writer = mesh is None or mesh.frame_index == 0
    try:
        store = FeatureStore(args.store, class_names=list(dataset.class_names),
                             process_index=mesh.data_index if mesh else 0,
                             dtype=args.store_dtype, quant=cfg.quant)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if act_max is not None and writer:
        store.set_quant_calib(act_max)
    metrics = MetricsWriter(args.metrics if pdist.rank() == 0 else None)
    metrics.write("config", command="extract", config=resolved_dict(cfg),
                  device=str(device), multichip=bool(args.multichip))
    try:
        stats = extract_features(dataset, weights, store, cfg, metrics,
                                 device=device, act_max=act_max, mesh=mesh)
    finally:
        metrics.close()
    print(json.dumps(stats))
    return 0


def cmd_eval(args) -> int:
    import numpy as np

    from eov_tpu_torch.config import get_preset, resolved_dict
    from eov_tpu_torch.data.store import FeatureStore
    from eov_tpu_torch.embodied import align_virtual_bank
    from eov_tpu_torch.eval import evaluate
    from eov_tpu_torch.parallel.sharded import evaluate_sharded
    from eov_tpu_torch.utils.device import resolve_device
    from eov_tpu_torch.utils.metrics import MetricsWriter

    mesh = None
    if args.multichip:
        mesh, device = _multichip(args)
    else:
        device = resolve_device(args.device)
    main = mesh is None or mesh.rank == 0
    preset = get_preset(args.preset)
    overrides = {f: getattr(args, f) for f in (
        "n_way", "k_shot", "n_query", "n_episodes", "metric", "fusion",
        "matcher", "seed") if getattr(args, f) is not None}
    if args.embodied:
        overrides["embodied"] = True
    cfg = dataclasses.replace(preset.eval, **overrides)
    store = FeatureStore(args.store)
    table = store.to_table(device)
    virtual = None
    if cfg.embodied:
        if not args.virtual_store:
            raise SystemExit("--virtual-store required for embodied eval")
        vstore = FeatureStore(args.virtual_store)
        # Real and virtual features are compared in one similarity space:
        # a recorded precision mismatch between the banks is refused.
        rq, rk = store.recorded_quant()
        vq, vk = vstore.recorded_quant()
        if rk and vk and rq != vq:
            raise SystemExit(
                f"embodied eval mixes precisions: --store was extracted "
                f"with quant={rq or 'off'} but --virtual-store with "
                f"quant={vq or 'off'}; re-extract one bank so both match")
        try:
            virtual = align_virtual_bank(store.class_names,
                                         vstore.class_names,
                                         vstore.to_table(device))
        except ValueError as e:
            raise SystemExit(str(e)) from None
    metrics = MetricsWriter(args.metrics if main else None)
    metrics.write("config", command="eval", config=resolved_dict(cfg),
                  device=str(device), multichip=bool(args.multichip))
    try:
        res = (evaluate(table, cfg, virtual=virtual) if mesh is None else
               evaluate_sharded(table, cfg, mesh, virtual=virtual))
    except ValueError as e:  # e.g. --matcher pallas with --device cpu
        raise SystemExit(str(e)) from None
    metrics.write("eval_result", mean_acc=res.mean_acc, ci95=res.ci95,
                  n_episodes=len(res.per_episode))
    metrics.close()
    if not main:  # every rank holds the result; rank 0 reports it
        return 0
    if args.per_episode_out:
        # Same format as the reference's, for paired comparisons
        # (tools/compare_eval.py of either package reads either's file).
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


def _class_scores(query, feats, mask, *, metric: str, fusion: str):
    """Scores [Q, C] of every query against every class of a whole split
    (features [C, M, D], mask [C, M]) as one episode of the matcher (kernel
    3 on the GPU), in chunks of queries and classes that keep each call
    within the kernel's row limit."""
    import torch

    from eov_tpu_torch.ops import similarity

    c, m = feats.shape[:2]
    n_chunk = max(1, min(c, similarity.MAX_ROWS // 2 // m))
    q_chunk = similarity.MAX_ROWS - n_chunk * m
    if q_chunk < 1:
        raise SystemExit(f"{m} support members per class exceed the "
                         f"matcher's {similarity.MAX_ROWS} rows")
    cols = []
    for c0 in range(0, c, n_chunk):
        f, k = feats[None, c0:c0 + n_chunk], mask[None, c0:c0 + n_chunk]
        cols.append(torch.cat([
            similarity.episode_class_scores(
                query[None, q0:q0 + q_chunk], f, k, metric=metric,
                fusion=fusion)[0]
            for q0 in range(0, query.shape[0], q_chunk)]))
    return torch.cat(cols, dim=1)


def cmd_classify(args) -> int:
    """Classify query clips against a one-shot support store: every clip of
    ``--store`` is a support example of its class (plus, with
    ``--embodied``, the aligned clips of ``--virtual-store``); each query
    clip of the dataset is featurized as the store was and takes the class
    with the best fused similarity. One JSON line per clip; with labels
    over the same class names an accuracy line goes to stderr."""
    import numpy as np
    import torch

    from eov_tpu_torch.config import get_preset, resolved_dict
    from eov_tpu_torch.data.store import FeatureStore, MemoryFeatureStore
    from eov_tpu_torch.embodied import union_support
    from eov_tpu_torch.extract import extract_features
    from eov_tpu_torch.utils.debug import check_finite
    from eov_tpu_torch.utils.device import resolve_device
    from eov_tpu_torch.utils.metrics import MetricsWriter

    device = resolve_device(args.device)
    preset = get_preset(args.preset)
    cfg = _extract_config(args)
    # The matcher's rules default to the preset's eval protocol.
    metric = args.metric or preset.eval.metric
    fusion = args.fusion or preset.eval.fusion
    store = FeatureStore(args.store)
    class_names = store.class_names
    # The full class axis: a class with no clips stays a masked row.
    table = store.to_table(device, n_classes=len(class_names) or None)
    if args.embodied and not args.virtual_store:
        raise SystemExit("--virtual-store required for --embodied")
    vstore = FeatureStore(args.virtual_store) if args.embodied else None
    # Provenance: queries featurized at another precision than a store's
    # would skew every similarity; a recorded mismatch is refused, a store
    # that records nothing is warned about.
    for s, role in ((store, "support"), (vstore, "virtual")):
        if s is None:
            continue
        rq, known = s.recorded_quant()
        if known and rq != cfg.quant:
            raise SystemExit(
                f"{role} store {s.root} was extracted with "
                f"quant={rq or 'off'} but queries would be featurized with "
                f"quant={cfg.quant or 'off'}; pass --quant {rq or 'off'} or "
                "re-extract the store at the query precision")
        if not known and cfg.quant:
            print(f"warning: {role} store {s.root} records no extraction "
                  "precision; cannot verify it matches --quant "
                  f"{cfg.quant}", file=sys.stderr)
        elif cfg.quant and s.quant_calib() is None:
            print(f"warning: {role} store {s.root} records no calibration "
                  "scales; queries are featurized with locally recalibrated "
                  "(synthetic-fixture) scales, which may not match the "
                  "program that produced it", file=sys.stderr)
    # Queries run the support store's exact int8 program: its scales.
    act_max = store.quant_calib() if cfg.quant else None
    if act_max is not None and vstore is not None:
        vcal = vstore.quant_calib()
        if vcal is not None and vcal != act_max:
            raise SystemExit(
                f"--store and --virtual-store record different int8 "
                "calibrations; their features come from two programs — "
                "re-extract one with the other's scales")
    try:
        feats, mask = union_support(
            table, class_names, vstore.class_names if vstore else None,
            vstore.to_table(device) if vstore else None)
    except ValueError as e:
        raise SystemExit(str(e)) from None

    weights = _load_weights(args, cfg.arch)
    dataset = _load_dataset(args)
    qstore = MemoryFeatureStore(class_names=list(dataset.class_names))
    stats = extract_features(dataset, weights, qstore, cfg, device=device,
                             act_max=act_max)
    qfeats = qstore.load_all()
    if not qfeats:
        raise SystemExit("no query clips could be featurized")
    ids = sorted(qfeats)
    query = torch.from_numpy(np.stack([qfeats[v][0] for v in ids])).to(device)
    if query.shape[-1] != feats.shape[-1]:
        raise SystemExit(
            f"query features are {query.shape[-1]}-d but the support store "
            f"holds {feats.shape[-1]}-d; use the same --arch/--params as "
            "extract")
    scores = check_finite("class scores", _class_scores(
        query, feats, mask, metric=metric, fusion=fusion))
    # A class with no support member (real or virtual) is not assignable.
    eligible = mask.sum(dim=1) > 0
    if not bool(eligible.any()):
        raise SystemExit("support store has no classes with any clips")
    scores[:, ~eligible] = -float("inf")
    preds = scores.argmax(dim=-1).cpu().numpy()
    best = scores.max(dim=-1).values.cpu().numpy()

    metrics = MetricsWriter(args.metrics)
    metrics.write("config", command="classify", config=resolved_dict(cfg),
                  metric=metric, fusion=fusion, device=str(device),
                  n_support_classes=len(class_names), n_queries=len(ids),
                  failed=stats["failed"])
    if stats["failed"]:
        print(f"warning: {stats['failed']} of {stats['total']} query clips "
              "failed to decode and are missing from the output",
              file=sys.stderr)
    lines = [json.dumps({"video_id": vid,
                         "pred_class": class_names[int(preds[i])],
                         "score": float(best[i])})
             for i, vid in enumerate(ids)]
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(line + "\n" for line in lines))
    else:
        print("\n".join(lines))
    name_to_idx = {c: i for i, c in enumerate(class_names)}
    truths = [name_to_idx.get(dataset.class_names[qfeats[v][1]]) for v in ids]
    known = [(p, t) for p, t in zip(preds, truths) if t is not None]
    if known:
        acc = float(np.mean([p == t for p, t in known]))
        metrics.write("classify_result", accuracy=acc, n=len(known),
                      failed=stats["failed"])
        print(f"labeled queries: {len(known)}/{len(ids)}, accuracy "
              f"{acc * 100:.2f}%", file=sys.stderr)
    metrics.close()
    return 0


def cmd_episode(args) -> int:
    """One N-way 1-shot episode from raw clips: per class one support and
    one query clip (seeded), featurized one at a time, scored by the
    matcher. Prints ``{"n_way", "accuracy", "preds", "truth"}``."""
    import numpy as np
    import torch

    from eov_tpu_torch.data.segments import center_indices_np
    from eov_tpu_torch.extract import make_feature_fn
    from eov_tpu_torch.ops.similarity import episode_class_scores
    from eov_tpu_torch.utils.debug import check_finite
    from eov_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = _extract_config(args)
    dataset = _load_dataset(args)
    fn = make_feature_fn(_load_weights(args, cfg.arch), cfg, device)
    n_way = args.n_way or 5
    rng = np.random.default_rng(args.seed)
    by_class: dict[int, list] = {}
    for r in dataset.records:
        by_class.setdefault(r.label, []).append(r)
    classes = rng.choice(sorted(by_class), size=n_way, replace=False)

    def feat(rec):
        idx = center_indices_np(rec.num_frames, cfg.num_segments)
        return fn(torch.from_numpy(dataset.get_frames(rec, idx)[None]))[0]

    sup, qry = [], []
    for c in classes:
        picks = rng.choice(len(by_class[c]), size=2, replace=False)
        sup.append(feat(by_class[c][picks[0]]))
        qry.append(feat(by_class[c][picks[1]]))
    support = torch.stack(sup)[None, :, None]  # [1, N, 1, D]
    mask = torch.ones(support.shape[:3], device=support.device)
    scores = check_finite("episode scores", episode_class_scores(
        torch.stack(qry)[None], support, mask))
    preds = scores.argmax(dim=-1)[0].cpu().numpy()
    truth = list(range(n_way))
    acc = float((preds == np.array(truth)).mean())
    print(json.dumps({"n_way": n_way, "accuracy": acc,
                      "preds": preds.tolist(), "truth": truth}))
    return 0


def cmd_store_info(args) -> int:
    """A store's merged summary (clips, classes, dtype, quant, shards,
    bytes, ...) as one JSON line."""
    from eov_tpu_torch.data.store import FeatureStore

    if not os.path.isdir(args.store):
        # Read-only: never create the root of a mistyped path.
        raise SystemExit(f"no feature store at {args.store}")
    print(json.dumps(FeatureStore(args.store).summary()))
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
            raise SystemExit(
                f"--select best: no best.json under {path} — train with "
                "--val-class-split to record per-epoch meta-val accuracy")
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
                 val_episodes: int = 120, val_segments: int = 8,
                 mesh=None) -> dict:
    """The train command's body: warm start, resume, epochs, a checkpoint
    per epoch, and with ``val_dataset`` a meta-val one-shot score per
    epoch with the best recorded in ``out/best.json``. Returns the last
    epoch's metrics.

    With a ``mesh`` every rank trains its block of each global batch; rank
    0 alone writes the checkpoints, ``best.json`` and the metrics (a
    barrier follows each checkpoint), every rank resumes from the same
    checkpoint, and rank 0's meta-val score is every rank's."""
    from eov_tpu_torch import train as tr
    from eov_tpu_torch.config import resolved_dict
    from eov_tpu_torch.parallel import distributed as pdist
    from eov_tpu_torch.utils.checkpoint import (latest_step_dir, load_state,
                                                save_state)
    from eov_tpu_torch.utils.metrics import MetricsWriter

    main = pdist.rank() == 0
    say = print if main else (lambda *a, **k: None)
    metrics = MetricsWriter(metrics_path if main else None)
    metrics.write("config", command="train", config=resolved_dict(cfg),
                  device=str(device), multichip=mesh is not None)
    state = tr.create_train_state(cfg, device)
    if params:
        warm_start(state, params, cfg.num_classes)
    start_epoch = 0
    last = latest_step_dir(out) if out else None
    if last:  # resume takes precedence over the warm start
        load_state(last, state)
        start_epoch = int(os.path.basename(last).split("_")[1]) + 1
        say(f"resumed from {last} (epoch {start_epoch})")
    step_fn = tr.make_train_step(cfg, device, mesh=mesh)
    best = None  # (val_acc, ci95, epoch)
    best_path = os.path.join(out, "best.json") if out else None
    if best_path and os.path.exists(best_path):
        with open(best_path) as f:
            doc = json.load(f)
        best = (doc["val_acc"], doc["ci95"], doc["epoch"])
    m: dict = {}
    for epoch in range(start_epoch, epochs):
        state, m = tr.train_epoch(state, step_fn, cfg, dataset, epoch=epoch,
                                  mesh=mesh)
        metrics.write("epoch", epoch=epoch, **m)  # with the epoch's report
        shown = {k: v for k, v in m.items() if k != "report"}
        say(f"epoch {epoch}: {shown}")
        if out and main:
            save_state(os.path.join(out, f"step_{epoch}"), state)
        pdist.barrier()
        if val_dataset is None:
            continue
        res = tr.one_shot_validate(
            state, cfg, val_dataset, n_way=val_n_way,
            n_episodes=val_episodes, num_segments=val_segments,
            seed=cfg.seed) if main else None
        res = pdist.broadcast_object(res)
        metrics.write("val", epoch=epoch, val_acc=res.mean_acc,
                      ci95=res.ci95, n_episodes=val_episodes)
        say(f"epoch {epoch} meta-val one-shot {res}")
        if best is None or res.mean_acc > best[0]:
            best = (res.mean_acc, res.ci95, epoch)
            if best_path and main:
                tmp = best_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({"epoch": epoch, "val_acc": res.mean_acc,
                               "ci95": res.ci95, "dir": f"step_{epoch}"}, f)
                os.replace(tmp, best_path)
    metrics.close()
    pdist.barrier()  # best.json is written before any rank returns
    if out:
        say(f"saved checkpoints under: {out}")
        if best is not None:
            say(f"best meta-val epoch {best[2]}: {best[0] * 100:.2f}% +/- "
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


def _val_split_spec(spec: str) -> str:
    """A --val-class-split spec with the part defaulting to 'val': the bare
    'path.json' and 'path.json:' would otherwise take _load_dataset's
    default 'test' and select models on the meta-test classes."""
    path, _, part = spec.partition(":")
    return f"{path}:{part or 'val'}"


def cmd_train(args) -> int:
    from eov_tpu_torch.utils.device import resolve_device

    mesh = None
    if args.multichip:
        mesh, device = _multichip(args)
    else:
        device = resolve_device(args.device)
    dataset = _load_dataset(args)
    cfg = _train_config(args, len(dataset.class_names), num_segments=3)
    if mesh is not None and cfg.batch_clips % mesh.n_data:
        # The global batch rounds down to the data size (at least one clip
        # a rank).
        b = cfg.batch_clips
        cfg = dataclasses.replace(cfg, batch_clips=max(b - b % mesh.n_data,
                                                       mesh.n_data))
    # Meta-val for per-epoch one-shot model selection: the same source,
    # the val class partition (disjoint from the meta-train classes).
    val_dataset = None
    if args.val_class_split:
        spec = _val_split_spec(args.val_class_split)
        val_dataset = _load_dataset(
            argparse.Namespace(**{**vars(args), "class_split": spec}))
    val = {k: v for k, v in (("val_episodes", args.val_episodes),
                             ("val_n_way", args.val_n_way),
                             ("val_segments", args.val_segments))
           if v is not None}
    run_training(cfg, dataset, device=device, epochs=args.epochs,
                 out=args.out, params=args.params, metrics_path=args.metrics,
                 val_dataset=val_dataset, mesh=mesh, **val)
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


def cmd_fixtures(args) -> int:
    """Write the synthetic dataset as JPEG frame folders (``--root/<video
    id>/img_NNNNN.jpg``, quality 90) and ``--root/split.json``, as the
    reference's ``fixtures`` writes them."""
    import numpy as np
    from PIL import Image  # lazily: the GPU machine has no PIL

    from eov_tpu_torch.data import datasets
    from eov_tpu_torch.data.fixtures import synthetic_clip

    ds = datasets.SyntheticVideoDataset(
        n_classes=args.synthetic_classes, clips_per_class=args.synthetic_clips,
        height=args.synthetic_height, width=args.synthetic_width,
        seed=args.seed)
    split = []
    for rec in ds.records:
        c, j = ds._meta[rec.video_id]
        clip = synthetic_clip(c, j, rec.num_frames, ds.height, ds.width)
        vdir = os.path.join(args.root, rec.video_id)
        os.makedirs(vdir, exist_ok=True)
        for t in range(rec.num_frames):
            Image.fromarray(np.ascontiguousarray(clip[t])).save(
                os.path.join(vdir, f"img_{t + 1:05d}.jpg"), quality=90)
        split.append([rec.video_id, rec.num_frames, rec.label])
    datasets.save_split_json(os.path.join(args.root, "split.json"),
                             ds.class_names, {"all": split})
    print(f"wrote {len(split)} videos under {args.root}")
    return 0


def cmd_presets(args) -> int:
    """One line per preset, name and description; ``--verbose`` adds its
    eval and extract configs."""
    from eov_tpu_torch.config import PRESETS, resolved_dict

    for p in PRESETS.values():
        print(f"{p.name:20s} {p.description}")
        if args.verbose:
            print(json.dumps({"eval": resolved_dict(p.eval),
                              "extract": resolved_dict(p.extract)}, indent=1))
    return 0


def cmd_bench(args) -> int:
    """The feature bench (``bench/features.py``); ``--platform`` sets
    ``EOV_BENCH_DEVICE``."""
    from eov_tpu_torch.bench import features

    if getattr(args, "device", None) is not None:
        os.environ["EOV_BENCH_DEVICE"] = args.device
    features.main()
    return 0


def _add_dataset(p: argparse.ArgumentParser) -> None:
    """The dataset flags of every command that reads clips."""
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "framedir", "videodir", "eovc"])
    p.add_argument("--root", default=None,
                   help="framedir/videodir root, or an EOVC file or shard "
                        "directory")
    p.add_argument("--split", default=None,
                   help="TSN split txt or split json")
    p.add_argument("--split-name", default="all",
                   help="which list of a split json")
    p.add_argument("--class-split", default=None, dest="class_split",
                   metavar="JSON[:part]",
                   help="keep one part of a class split (default part "
                        "'test'), e.g. eov_tpu_torch/splits/"
                        "ucf101_oneshot.json:test")
    p.add_argument("--jpeg-scale-denom", type=int, default=1,
                   dest="jpeg_scale_denom", choices=[1, 2, 4, 8],
                   help="eovc jpeg shards: DCT-scaled decode at 1/denom of "
                        "the storage size (native loader)")
    p.add_argument("--synthetic-classes", type=int, default=10)
    p.add_argument("--synthetic-clips", type=int, default=8)
    p.add_argument("--synthetic-height", type=int, default=128)
    p.add_argument("--synthetic-width", type=int, default=160)


def _add_clips(p: argparse.ArgumentParser) -> None:
    """Dataset and feature-program flags (extract, classify, episode)."""
    _add_dataset(p)
    p.add_argument("--synthetic-virtual", action="store_true",
                   dest="synthetic_virtual",
                   help="virtual-agent rendering (UnrealAction analog)")
    p.add_argument("--params", default=None,
                   help="train-run dir, or a torchvision .pth/.pt/.npz "
                        "state_dict")
    p.add_argument("--arch", default=None,
                   help="backbone arch (resnet18/34/50/101/152)")
    p.add_argument("--num-segments", type=int, default=None)
    p.add_argument("--batch", type=int, default=None,
                   help="clips per device batch (default: the preset's)")
    p.add_argument("--scale-size", type=int, default=None,
                   help="eval short-side scale (default: the preset's)")
    p.add_argument("--crop-size", type=int, default=None,
                   help="eval center crop (default: the preset's)")


def _add_train_common(p: argparse.ArgumentParser) -> None:
    _add_dataset(p)
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

    quant_help = ("backbone precision: 'off' = the bf16/f32 forward "
                  "(default), 'int8' = the int8 forward (stage 1 through "
                  "kernel 7)")
    select_help = ("when --params is a train-run dir: newest epoch "
                   "checkpoint, or best.json's meta-val winner")
    multichip_help = ("one process per GPU under torchrun (python -m "
                      "torch.distributed.run --nproc_per_node N -m "
                      "eov_tpu_torch.cli ...) over the ('data', 'frame') "
                      "mesh; without a launcher a world of 1")

    ex = sub.add_parser("extract", help="dataset -> clip feature store")
    _add_common(ex)
    _add_clips(ex)
    ex.add_argument("--fused-stages", type=_fused_stages, default=None,
                    metavar="SPEC",
                    help="'auto' (default), 'none', or a list like '1,2'")
    ex.add_argument("--fused-group", type=_positive_int, dest="fused_group",
                    default=None,
                    help="accepted for the reference's CLI and ignored: "
                         "images per fused-kernel grid step on a TPU "
                         "(bit-identical results for every value)")
    ex.add_argument("--pallas-pool", dest="pallas_pool", default=None,
                    choices=("off", "on", "fused"),
                    help="stem max-pool: 'off' = cuDNN (default), 'on' = "
                         "kernel 6, 'fused' = inside the stage-1 stack "
                         "(kernel 5, bottleneck archs); needs fused stages")
    ex.add_argument("--select", choices=("latest", "best"), default="latest",
                    help=select_help)
    ex.add_argument("--store-dtype", default=None,
                    choices=("float32", "float16"))
    ex.add_argument("--quant", default=None, choices=("off", "int8"),
                    help=quant_help)
    ex.add_argument("--quant-calib", dest="quant_calib", default=None,
                    choices=("synthetic", "dataset"),
                    help="int8 scale calibration: deterministic synthetic "
                         "fixtures (default) or the dataset's first clips; "
                         "recorded in the store, classify reuses them")
    ex.add_argument("--multichip", action="store_true", help=multichip_help)
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
    ev.add_argument("--embodied", action="store_true",
                    help="add --virtual-store's clips to each support set")
    ev.add_argument("--virtual-store", dest="virtual_store", default=None)
    ev.add_argument("--matcher", choices=["auto", "xla", "pallas"],
                    help="scorer: auto = kernel 3 on the GPU, the plain "
                         "version on the CPU (default); xla = the plain "
                         "version; pallas = kernel 3 (GPU only)")
    ev.add_argument("--per-episode-out", dest="per_episode_out",
                    default=None, metavar="FILE",
                    help="per-episode accuracies and the protocol as JSON, "
                         "for tools/compare_eval.py")
    ev.add_argument("--multichip", action="store_true", help=multichip_help)
    ev.set_defaults(fn=cmd_eval)

    cl = sub.add_parser("classify",
                        help="classify new clips against a support store")
    _add_common(cl)
    _add_clips(cl)
    cl.add_argument("--quant", default=None, choices=("off", "int8"),
                    help="query precision; must match the support store's")
    cl.add_argument("--select", choices=("latest", "best"), default="latest",
                    help=select_help)
    cl.add_argument("--embodied", action="store_true",
                    help="add --virtual-store's clips to each class")
    cl.add_argument("--virtual-store", dest="virtual_store", default=None)
    cl.add_argument("--metric", choices=["cosine", "euclidean"])
    cl.add_argument("--fusion", choices=["max", "mean"])
    cl.add_argument("--out", default=None, metavar="FILE",
                    help="per-clip JSON lines here instead of stdout")
    cl.set_defaults(fn=cmd_classify)

    es = sub.add_parser("episode", help="one N-way 1-shot episode from clips")
    es.add_argument("--preset", default="ucf101_600",
                    help="config preset (see eov_tpu_torch/config.py)")
    es.add_argument("--seed", type=int, default=0)
    es.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    es.add_argument("--n-way", type=int, dest="n_way")
    _add_clips(es)
    es.set_defaults(fn=cmd_episode)

    si = sub.add_parser("store-info", help="a store's summary (JSON)")
    si.add_argument("--store", required=True, help="feature store directory")
    si.set_defaults(fn=cmd_store_info)

    tr = sub.add_parser("train", help="TSN finetune of the backbone")
    _add_train_common(tr)
    tr.add_argument("--epochs", type=int, default=1)
    tr.add_argument("--lr", type=float, default=None)
    tr.add_argument("--out", default=None,
                    help="run dir: step_N checkpoints, best.json, resume")
    tr.add_argument("--multichip", action="store_true",
                    help=multichip_help)
    tr.add_argument("--val-class-split", dest="val_class_split",
                    default=None, metavar="JSON[:part]",
                    help="meta-val class split (default part 'val'): score "
                         "each epoch by one-shot episodic accuracy on these "
                         "held-out classes and record the best checkpoint "
                         "in best.json")
    tr.add_argument("--val-episodes", type=int, dest="val_episodes",
                    default=None,
                    help="episodes per meta-val pass (default 120)")
    tr.add_argument("--val-n-way", type=int, dest="val_n_way", default=None,
                    help="n-way of the meta-val episodes (default 5)")
    tr.add_argument("--val-segments", type=int, dest="val_segments",
                    default=None,
                    help="eval-time TSN K for the meta-val features "
                         "(default 8, independent of --num-segments)")
    tr.set_defaults(fn=cmd_train)

    te = sub.add_parser("test", help="top-1 of a train run's checkpoint")
    _add_train_common(te)
    te.add_argument("--select", choices=("latest", "best"), default="latest",
                    help="newest epoch of the run dir, or best.json's")
    te.set_defaults(fn=cmd_test)

    fx = sub.add_parser("fixtures",
                        help="write the synthetic dataset as JPEG frame "
                             "folders + split.json")
    fx.add_argument("--root", required=True, help="output directory")
    fx.add_argument("--seed", type=int, default=0)
    fx.add_argument("--synthetic-classes", type=int, default=10)
    fx.add_argument("--synthetic-clips", type=int, default=8)
    fx.add_argument("--synthetic-height", type=int, default=128)
    fx.add_argument("--synthetic-width", type=int, default=160)
    fx.set_defaults(fn=cmd_fixtures)

    pr = sub.add_parser("presets", help="list the config presets")
    pr.add_argument("--verbose", action="store_true")
    pr.set_defaults(fn=cmd_presets)

    be = sub.add_parser("bench", help="the feature bench (one JSON line)")
    be.set_defaults(fn=cmd_bench)

    for p in sub.choices.values():
        _add_global(p)
    args = ap.parse_args(argv)
    _platform_device(args)
    return _run(args)


def _run(args) -> int:
    """The command, under ``--debug-nans`` and ``--trace`` when given."""
    import contextlib

    import torch

    with contextlib.ExitStack() as stack:
        if args.debug_nans:
            from eov_tpu_torch.utils.debug import debug_nans

            stack.enter_context(debug_nans())
            if args.cmd == "train":
                stack.enter_context(torch.autograd.set_detect_anomaly(True))
        if args.trace:
            from eov_tpu_torch.utils.trace import trace

            device = getattr(args, "device", None)
            if args.cmd == "bench" and device is None:
                device = os.environ.get("EOV_BENCH_DEVICE", "cuda")
            stack.enter_context(trace(args.trace, device or "cpu"))
        return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
