"""Episodic one-shot evaluation: seeded episodes, matcher, mean ± 95% CI.

Counterpart of ``eov_tpu/eval.py`` (``EvalConfig``, ``FeatureTable``,
``eval_step``, ``evaluate``). Each step samples ``episodes_per_step``
episodes on the table's device with the canonical ordinal seeding
(episodes.py — the same episode sequence as the reference), gathers
support and query features, scores them with
``ops.similarity.episode_class_scores`` (kernel 3 on the GPU, for both
fusion rules) and returns per-episode accuracy. The host accumulates the
accuracy vector and the CI: mean ± 1.96·σ/√E (sample σ).

Embodied eval (``EvalConfig.embodied`` with a virtual bank from
``embodied.align_virtual_bank``) appends each chosen class's virtual
members to its support members, masked by the bank's counts; the episode
sequence is the plain protocol's, so the two runs pair episode by episode.

``EvalConfig.matcher`` picks the scorer, as the reference's does:
``"auto"`` (the default) is kernel 3 on a CUDA table and the plain version
on a CPU one; ``"pallas"`` is kernel 3 and is refused for a CPU table (the
kernel runs on the card only); ``"xla"`` is the plain PyTorch version
(``ops.similarity.episode_scores_plain``) on either device, an explicit
opt-in for A/B runs such as ``EOV_EVAL_MATCHER=xla`` in the eval bench.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from eov_tpu_torch import episodes as ep
from eov_tpu_torch import prng
from eov_tpu_torch.ops.similarity import episode_class_scores
from eov_tpu_torch.utils.debug import check_finite

__all__ = ["EvalConfig", "EvalResult", "FeatureTable", "MATCHERS",
           "eval_step", "evaluate", "check_protocol", "eval_result"]

MATCHERS = ("auto", "xla", "pallas")


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """One-shot eval protocol (the reference's defaults)."""

    n_way: int = 5
    k_shot: int = 1
    n_query: int = 1
    n_episodes: int = 600
    episodes_per_step: int = 64
    metric: str = "cosine"  # 'cosine' | 'euclidean'
    fusion: str = "max"     # 'max' (union support) | 'mean' (prototype)
    seed: int = 0
    embodied: bool = False  # append the virtual support bank
    matcher: str = "auto"   # 'auto' | 'xla' (plain) | 'pallas' (kernel 3)


class FeatureTable(NamedTuple):
    """features [C, M, D] float32 (class-major slots), counts [C] int64."""

    features: torch.Tensor
    counts: torch.Tensor


class EvalResult(NamedTuple):
    mean_acc: float
    ci95: float
    per_episode: np.ndarray  # [E] accuracies in sample order

    def __str__(self) -> str:
        return (f"accuracy: {self.mean_acc * 100:.2f}% "
                f"+/- {self.ci95 * 100:.2f}%")


def _plain_matcher(matcher: str, device: torch.device) -> bool:
    """Whether ``matcher`` scores with the plain version on ``device``;
    refuses an unknown name and 'pallas' off the card."""
    if matcher not in MATCHERS:
        raise ValueError(f"matcher={matcher!r}: expected one of {MATCHERS}")
    if matcher == "pallas" and device.type != "cuda":
        raise ValueError(
            f"matcher='pallas' is kernel 3, which runs on a CUDA device only; "
            f"the features are on {device} (use 'auto' or 'xla')")
    return matcher == "xla"


def eval_step(key: torch.Tensor, base_ordinal: int, features: torch.Tensor,
              counts: torch.Tensor, virtual_feats: torch.Tensor | None = None,
              virtual_counts: torch.Tensor | None = None, *, n_way: int,
              k_shot: int, n_query: int, n_step: int, metric: str,
              fusion: str, matcher: str = "auto") -> torch.Tensor:
    """Accuracy [n_step] of the episodes with global ordinals
    [base_ordinal, base_ordinal + n_step), on the features' device. With a
    virtual bank ([C, V, D] and [C] counts) each chosen class's virtual
    members join its support members. ``matcher`` as ``EvalConfig``'s."""
    plain = _plain_matcher(matcher, features.device)
    idx = ep.sample_episodes(
        key, counts, n_way=n_way, k_shot=k_shot, n_query=n_query,
        n_episodes=n_step, max_clips=features.shape[1],
        base_ordinal=base_ordinal,
    )
    cls = idx.class_ids[..., None]
    sup = features[cls, idx.support_idx]  # [E, N, K, D]
    qry = features[cls, idx.query_idx]    # [E, N, Q, D]
    mask = torch.ones(sup.shape[:-1], dtype=torch.float32,
                      device=features.device)
    if virtual_feats is not None:
        virt = virtual_feats[idx.class_ids]  # [E, N, V, D]
        vmask = (torch.arange(virtual_feats.shape[1],
                              device=features.device)[None, None, :]
                 < virtual_counts[idx.class_ids][..., None]).float()
        sup = torch.cat([sup, virt], dim=2)
        mask = torch.cat([mask, vmask], dim=2)
    qry_flat = qry.reshape(n_step, n_way * n_query, -1)
    scores = check_finite("episode scores", episode_class_scores(
        qry_flat, sup, mask, metric=metric, fusion=fusion, plain=plain))
    preds = scores.argmax(dim=-1)  # ties to the lower class, as jnp.argmax
    labels = ep.query_labels(n_way, n_query, features.device)[None, :]
    # sum * (1/n), the f32 rounding XLA gives the reference's jnp.mean
    hits = (preds == labels).float().sum(dim=-1)
    return hits * (1.0 / (n_way * n_query))


def check_protocol(table: FeatureTable, cfg: EvalConfig,
                   virtual: FeatureTable | None = None) -> None:
    """The host-side refusals of ``evaluate`` (and of the sharded eval):
    embodied without a bank, a bank of another feature width, an unknown
    matcher, too few eligible classes."""
    if cfg.embodied and virtual is None:
        raise ValueError("embodied eval requires a virtual FeatureTable")
    if cfg.embodied:
        d_real = table.features.shape[-1]
        d_virt = virtual.features.shape[-1]
        if d_real != d_virt:
            raise ValueError(
                f"real ({d_real}-d) and virtual ({d_virt}-d) features were "
                "extracted with different backbones; re-extract one side")
    _plain_matcher(cfg.matcher, table.features.device)  # refuse up front
    need = cfg.k_shot + cfg.n_query
    n_eligible = int((table.counts >= need).sum())
    if n_eligible < cfg.n_way:
        raise ValueError(f"only {n_eligible} classes have >= {need} clips; "
                         f"n_way={cfg.n_way} episodes are not sampleable")


def eval_result(per_episode: np.ndarray) -> EvalResult:
    """Mean ± 1.96·σ/√E (sample σ) of the per-episode accuracies."""
    mean = float(per_episode.mean())
    std = float(per_episode.std(ddof=1)) if len(per_episode) > 1 else 0.0
    ci = 1.96 * std / np.sqrt(len(per_episode))
    return EvalResult(mean_acc=mean, ci95=float(ci), per_episode=per_episode)


def evaluate(table: FeatureTable, cfg: EvalConfig,
             virtual: FeatureTable | None = None) -> EvalResult:
    """Run the protocol over the table (on its device): E episodes in steps
    of ``episodes_per_step``, mean ± 95% CI. ``cfg.embodied`` needs the
    ``virtual`` bank (aligned to the table's classes, same device)."""
    check_protocol(table, cfg, virtual)
    vf = virtual.features if cfg.embodied else None
    vc = virtual.counts if cfg.embodied else None
    key = prng.key(cfg.seed, device=table.features.device)
    accs, done = [], 0
    # Every step runs at the full step shape; the tail step's extra
    # episodes are computed and dropped, as in the reference.
    while done < cfg.n_episodes:
        acc = eval_step(
            key, done, table.features, table.counts, vf, vc, n_way=cfg.n_way,
            k_shot=cfg.k_shot, n_query=cfg.n_query,
            n_step=cfg.episodes_per_step, metric=cfg.metric,
            fusion=cfg.fusion, matcher=cfg.matcher,
        )
        take = min(cfg.episodes_per_step, cfg.n_episodes - done)
        accs.append(acc[:take])
        done += take
    return eval_result(torch.cat(accs).cpu().numpy())
