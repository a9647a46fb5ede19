"""Vectorized episodic N-way K-shot sampler, bit-exact to the JAX reference.

Counterpart of ``eov_tpu/episodes.py``. Episode g of a protocol draws its
randomness from ``fold_in(key, g)`` (g the GLOBAL episode ordinal), split into
a class key and a clip key; classes and clip slots come from ranked uniforms,
so one draw gives a uniform choice without replacement. The threefry bits
come from ``prng.py`` and match ``jax.random`` exactly, and ranking uses a
stable descending sort, which breaks ties toward the lower index as
``jax.lax.top_k`` does (``torch.topk`` leaves tie order unspecified). So the
port scores the identical episode sequence as the reference for any
``(seed, base_ordinal, counts)``, on either device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eov_tpu_torch import prng

__all__ = ["EpisodeIndices", "sample_episodes", "query_labels"]


class EpisodeIndices(NamedTuple):
    """class_ids [E, N], support_idx [E, N, K], query_idx [E, N, Q] (int64)."""

    class_ids: torch.Tensor
    support_idx: torch.Tensor
    query_idx: torch.Tensor


def _top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, ties to the lower index."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :k]


def sample_episodes(
    key: torch.Tensor,
    class_counts: torch.Tensor,
    *,
    n_way: int,
    k_shot: int,
    n_query: int,
    n_episodes: int,
    max_clips: int,
    base_ordinal: int = 0,
) -> EpisodeIndices:
    """Sample episodes with global ordinals [base, base + n_episodes).

    ``key`` is a ``prng.key`` pair on the device the draw should run on;
    ``class_counts`` [C] holds clips per class. Classes with fewer than
    ``k_shot + n_query`` clips are never selected.
    """
    c = class_counts.shape[0]
    need = k_shot + n_query
    if n_way > c:
        raise ValueError(f"n_way={n_way} > {c} classes")
    if need > max_clips:
        raise ValueError(f"k_shot+n_query={need} > max_clips={max_clips}")
    dev = key.device
    counts = class_counts.to(dev)

    ordinals = int(base_ordinal) + torch.arange(
        n_episodes, dtype=torch.int64, device=dev
    )
    ep_keys = prng.fold_in(key.expand(n_episodes, 2), ordinals)
    sub = prng.split(ep_keys, 2)  # [E, 2, 2]
    k_cls, k_clip = sub[:, 0], sub[:, 1]

    eligible = counts >= need
    cls_scores = prng.uniform(k_cls, (c,))
    cls_scores = torch.where(eligible[None, :], cls_scores,
                             torch.full_like(cls_scores, -1.0))
    class_ids = _top_k(cls_scores, n_way)  # [E, N]

    counts_sel = counts[class_ids]  # [E, N]
    slot_scores = prng.uniform(k_clip, (n_way, max_clips))
    valid = (torch.arange(max_clips, device=dev)[None, None, :]
             < counts_sel[..., None])
    slot_scores = torch.where(valid, slot_scores,
                              torch.full_like(slot_scores, -1.0))
    slots = _top_k(slot_scores, need)  # [E, N, need]
    return EpisodeIndices(class_ids, slots[..., :k_shot], slots[..., k_shot:])


def query_labels(n_way: int, n_query: int,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """Ground-truth labels [N*Q] for queries laid out class-major."""
    return torch.arange(n_way, device=device).repeat_interleave(n_query)
