"""Fused-vs-cached eval bench: the literal fused program against the cache.

Counterpart of the reference's ``bench_fused_eval.py``. Both sides run the
same canonical episode protocol (the port's sampler, ``episodes.py``, with
the same key and ordinals) over one bank of uint8 clips on the device:

* **A**, the fused step: sample ``EOV_FUSED_EPS_STEP`` 5-way 1-shot
  1-query episodes, gather their members' uint8 clips from the bank on the
  device, run the port's feature program (``make_feature_fn``: kernel 1
  crops 256x340 -> 224, then the folded ResNet with kernel 2 and cuDNN)
  on each ``EOV_FUSED_CHUNK``-clip chunk, take TSN consensus, score with
  the cosine/max matcher and return the step's mean accuracy;
* **B**, the cache: featurize the bank once with the same feature program
  (timed: ``extract_bank_s``), then run the cached ``eval_step`` with
  ``matcher='xla'`` (the plain matcher), as the reference does. A scores
  with the same plain matcher, so the two differ only in where each clip
  is featurized (episode-gather order against bank order).

Parity rail: ``acc_max_delta``, the largest per-step accuracy difference
over one window; 0 where the features are bit-equal, a near-tie flip
otherwise. The protocol totals are those of the reference: at E episodes,
A spends E/step x its step time, B the bank extraction plus E/step x its
step time.

Timing: one window of ``EOV_FUSED_WINDOW`` steps between two CUDA events
(the host clock on the CPU), ``EOV_FUSED_ITERS`` windows, window i with
key ``i``; the median window per step. The bank is drawn on the device
from a seeded ``torch.Generator`` (the reference draws it with numpy;
its values do not change the work).

Knobs (the reference's names and defaults): ``EOV_FUSED_CLASSES`` (24),
``EOV_FUSED_CLIPS`` (25), ``EOV_FUSED_FRAMES`` (8), ``EOV_FUSED_HW``
(256x340), ``EOV_FUSED_EPS_STEP`` (64), ``EOV_FUSED_ARCH`` (resnet50),
``EOV_FUSED_CHUNK`` (64), ``EOV_FUSED_ITERS`` (3), ``EOV_FUSED_WINDOW``
(2), ``EOV_FUSED_SCALE`` (256), ``EOV_FUSED_CROP`` (224),
``EOV_FUSED_EPISODES`` (600); and the port's ``EOV_FUSED_DTYPE``
(bfloat16 | float32) and ``EOV_BENCH_DEVICE`` (cuda | cpu).
Prints ONE JSON line, metric ``fused_vs_cached_eval_step``.
"""

from __future__ import annotations

import os
import statistics

import torch

from eov_tpu_torch.bench.common import (bench_device, build_kernels, card,
                                        emit, step_seconds)

__all__ = ["main", "gather_step_clips"]


def gather_step_clips(bank, counts, key, base_ordinal, *, n_way, k_shot,
                      n_query, n_episodes):
    """The uint8 clips of one fused step, gathered from ``bank`` [C, M, K,
    H, W, 3] on its device: [E, N, k_shot + n_query, K, H, W, 3], each
    episode's support members before its queries."""
    from eov_tpu_torch import episodes as ep

    idx = ep.sample_episodes(
        key, counts, n_way=n_way, k_shot=k_shot, n_query=n_query,
        n_episodes=n_episodes, max_clips=bank.shape[1],
        base_ordinal=base_ordinal)
    member = torch.cat([idx.support_idx, idx.query_idx], dim=-1)
    return bank[idx.class_ids[..., None], member]


def main() -> None:
    from eov_tpu_torch import episodes as ep
    from eov_tpu_torch import prng
    from eov_tpu_torch.eval import eval_step
    from eov_tpu_torch.extract import ExtractConfig, make_feature_fn
    from eov_tpu_torch.models.resnet import random_state_dict
    from eov_tpu_torch.ops.similarity import episode_class_scores

    dev = bench_device()
    c = int(os.environ.get("EOV_FUSED_CLASSES", "24"))
    m = int(os.environ.get("EOV_FUSED_CLIPS", "25"))
    k = int(os.environ.get("EOV_FUSED_FRAMES", "8"))
    fh, _, fw = os.environ.get("EOV_FUSED_HW", "256x340").partition("x")
    fh, fw = int(fh), int(fw)
    e_step = int(os.environ.get("EOV_FUSED_EPS_STEP", "64"))
    arch = os.environ.get("EOV_FUSED_ARCH", "resnet50")
    chunk = int(os.environ.get("EOV_FUSED_CHUNK", "64"))
    iters = int(os.environ.get("EOV_FUSED_ITERS", "3"))
    window = int(os.environ.get("EOV_FUSED_WINDOW", "2"))
    scale = int(os.environ.get("EOV_FUSED_SCALE", "256"))
    crop = int(os.environ.get("EOV_FUSED_CROP", "224"))
    protocol_e = int(os.environ.get("EOV_FUSED_EPISODES", "600"))
    dtype = os.environ.get("EOV_FUSED_DTYPE", "bfloat16")
    n_way, k_shot, n_query = 5, 1, 1
    s = k_shot + n_query

    try:
        ecfg = ExtractConfig(num_segments=k, arch=arch, batch_clips=chunk,
                             scale_size=scale, crop_size=crop,
                             compute_dtype=dtype)
    except ValueError as e:
        raise SystemExit(f"fused eval bench: {e}") from None
    build_s = build_kernels(dev)
    feature_fn = make_feature_fn(random_state_dict(arch, seed=0), ecfg, dev)

    total = e_step * n_way * s  # clips featurized per fused step
    if total % chunk:
        chunk = total  # one chunk: the program stays valid at any size
    gen = torch.Generator(device=dev).manual_seed(0)
    bank = torch.randint(0, 256, (c, m, k, fh, fw, 3), generator=gen,
                         dtype=torch.uint8, device=dev)
    counts = torch.full((c,), m, dtype=torch.int64, device=dev)
    labels = ep.query_labels(n_way, n_query, dev)[None, :]

    def scores_acc(qry, sup):
        """Mean accuracy of the step's episodes (the plain matcher)."""
        mask = torch.ones(sup.shape[:-1], dtype=torch.float32, device=dev)
        scores = episode_class_scores(qry, sup, mask, metric="cosine",
                                      fusion="max", plain=True)
        hits = (scores.argmax(dim=-1) == labels).float().sum(dim=-1)
        return (hits * (1.0 / (n_way * n_query))).mean()

    # ---- A: the literal fused program ----------------------------------
    def fused_step(key, base_ordinal):
        clips = gather_step_clips(bank, counts, key, base_ordinal,
                                  n_way=n_way, k_shot=k_shot,
                                  n_query=n_query, n_episodes=e_step)
        flat = clips.reshape(-1, chunk, k, fh, fw, 3)
        feats = torch.cat([feature_fn(flat[i]) for i in range(len(flat))])
        feats = feats.reshape(e_step, n_way, s, -1)
        sup, qry = feats[:, :, :k_shot], feats[:, :, k_shot:]
        return scores_acc(qry.reshape(e_step, n_way * n_query, -1), sup)

    # ---- B: extract the bank once, then the cached eval step ----------
    bank_flat = bank.reshape(c * m, k, fh, fw, 3)
    pad = -(c * m) % chunk
    if pad:
        bank_flat = torch.cat([bank_flat, bank_flat[:pad]])
    bank_chunks = bank_flat.reshape(-1, chunk, k, fh, fw, 3)

    def extract_bank():
        return torch.cat([feature_fn(bank_chunks[i])
                          for i in range(len(bank_chunks))])

    extract_bank()  # warm-up, untimed
    feats_out = []
    extract_bank_s = step_seconds(lambda: feats_out.append(extract_bank()),
                                  1, dev)
    features = feats_out[-1][:c * m].reshape(c, m, -1).float()
    del bank_flat, bank_chunks, feats_out

    def cached_step(key, base_ordinal):
        return eval_step(key, base_ordinal, features, counts, None, None,
                         n_way=n_way, k_shot=k_shot, n_query=n_query,
                         n_step=e_step, metric="cosine", fusion="max",
                         matcher="xla").mean()

    def window_accs(step, key):
        return torch.stack([step(key, i * e_step) for i in range(window)])

    # Parity rail: the same protocol gives the same per-step accuracies.
    key0 = prng.key(0, device=dev)
    acc_fused = window_accs(fused_step, key0)
    acc_cached = window_accs(cached_step, key0)
    acc_max_delta = float((acc_fused - acc_cached).abs().max())

    def timed(step):
        times = []
        for i in range(iters):
            key = prng.key(i, device=dev)
            ordinals = iter(range(0, window * e_step, e_step))
            times.append(step_seconds(lambda: step(key, next(ordinals)),
                                      window, dev))
        return statistics.median(times), times

    fused_s, fused_ts = timed(fused_step)
    cached_s, cached_ts = timed(cached_step)

    n_steps_protocol = -(-protocol_e // e_step)
    protocol_fused_s = n_steps_protocol * fused_s
    protocol_cached_s = extract_bank_s + n_steps_protocol * cached_s
    emit({
        "metric": "fused_vs_cached_eval_step",
        "value": round(fused_s / max(cached_s, 1e-12), 1),
        "unit": "x_slower_per_step",
        "vs_baseline": None,
        "detail": {
            "platform": dev.type,
            "gpu": card(dev),
            "arch": arch,
            "compute_dtype": dtype,
            "bank_cmk_hw": [c, m, k, fh, fw],
            "episodes_per_step": e_step,
            "backbone_chunk": chunk,
            "fused_step_s": round(fused_s, 6),
            "fused_eps_per_s": round(e_step / fused_s, 2),
            "fused_step_s_band": [round(min(fused_ts), 6),
                                  round(max(fused_ts), 6)],
            "cached_step_s": round(cached_s, 7),
            "cached_eps_per_s": round(e_step / cached_s, 1),
            "cached_step_s_band": [round(min(cached_ts), 7),
                                   round(max(cached_ts), 7)],
            "extract_bank_s": round(extract_bank_s, 4),
            "protocol_episodes": protocol_e,
            "protocol_fused_s": round(protocol_fused_s, 4),
            "protocol_cached_s_incl_extract": round(protocol_cached_s, 4),
            "protocol_speedup_cached": round(
                protocol_fused_s / max(protocol_cached_s, 1e-12), 2),
            "acc_max_delta": acc_max_delta,
            "acc_per_step_fused": [float(a) for a in acc_fused],
            "window": window,
            "iters": iters,
            "build_s": build_s,
            "params": "random_state_dict(seed=0) (the time does not depend "
                      "on the weights' values)",
        },
    })


if __name__ == "__main__":
    main()
