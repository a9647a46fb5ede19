"""Sharded extraction and eval steps over a ('data', 'frame') mesh.

Counterpart of ``eov_tpu/parallel/sharded.py``. Every rank runs the port's
single-GPU program on its block and the ranks meet in one collective:

* ``make_sharded_feature_fn`` — a rank's uint8 block [B/dp, K/fp, H, W, 3]
  -> clip features [B/dp, D]: the single-GPU feature program
  (``extract.make_segment_fn``: kernels 1 and 2, or kernel 7 under int8)
  on the block, the segment features summed in f32 and all-reduced over
  the frame ranks of the row, then divided by K_global. With one frame
  rank it is ``extract.make_feature_fn``'s own mean.
* ``evaluate_sharded`` — the episodic protocol with the episodes of each
  step split over the data ranks: data rank s scores ordinals ``base +
  s * e_local + [0, e_local)`` with ``eval.eval_step`` (kernel 3 on the
  GPU under ``cfg.matcher``) and one all-gather returns the [E] vector.
  The canonical ordinal protocol makes ``per_episode`` bit-identical to
  ``eval.evaluate`` for the same seed and matcher, whatever the world size
  and ``episodes_per_step``.

Two deliberate differences from the reference. The int8 scales are rank
0's, broadcast: each rank calibrates with cuDNN in its own process, and
every rank must quantize with the same scales (the reference relies on
every host deriving the same scales). And ``matcher`` is honoured per
rank (the reference warns and runs its XLA matcher under ``'pallas'``),
since kernel 3 is local compute.
"""

from __future__ import annotations

from typing import Callable

import torch

from eov_tpu_torch import prng
from eov_tpu_torch.parallel import distributed as pdist
from eov_tpu_torch.parallel.mesh import Mesh
from eov_tpu_torch.utils.debug import check_finite

__all__ = ["make_sharded_feature_fn", "evaluate_sharded"]


def make_sharded_feature_fn(weights, mesh: Mesh, cfg,
                            act_max: dict | None = None,
                            device: torch.device | str = "cuda") -> Callable:
    """The sharded clip featurizer of ``cfg`` (an ``ExtractConfig``): this
    rank's block [B/dp, K/fp, H, W, 3] -> features [B/dp, D] f32, equal
    on the frame ranks of a row.

    ``quant='int8'`` needs ``act_max`` (``extract.quant_calibration``);
    rank 0's scales are broadcast and every rank quantizes with them (the
    returned function's ``act_max``). The other refusals are
    ``make_feature_fn``'s (int8 fused stages other than ``(1,)`` or on a
    basic arch; int8 without the BN fold)."""
    from eov_tpu_torch.extract import make_segment_fn

    if cfg.quant is not None:
        if act_max is None:
            raise ValueError(
                "sharded quant='int8' needs pre-computed calibration scales "
                "(act_max=extract.quant_calibration(...)): every rank must "
                "quantize with identical scales")
        act_max = pdist.broadcast_object(act_max)
    if cfg.num_segments % mesh.n_frame:
        raise ValueError(f"num_segments={cfg.num_segments} not divisible by "
                         f"frame={mesh.n_frame}")
    segments = make_segment_fn(weights, cfg, device, act_max=act_max)

    @torch.inference_mode()
    def feature_fn(frames_u8: torch.Tensor) -> torch.Tensor:
        feats = segments(frames_u8)  # [b, k_local, D] f32
        if mesh.n_frame == 1:
            out = feats.mean(dim=1)
        else:
            k_global = feats.shape[1] * mesh.n_frame
            out = pdist.all_reduce(feats.sum(dim=1),
                                   mesh.frame_group) / k_global
        return check_finite("features", out)

    feature_fn.act_max = act_max
    return feature_fn


def evaluate_sharded(table, cfg, mesh: Mesh, virtual=None):
    """``eval.evaluate`` with each step's episodes split over the data
    ranks (see the module doc); every rank holds the whole table (and the
    embodied bank) and returns the whole result. ``episodes_per_step`` is
    rounded down to a multiple of the data size (at least one episode a
    rank); the tail step is computed in full and truncated."""
    from eov_tpu_torch.eval import check_protocol, eval_result, eval_step

    check_protocol(table, cfg, virtual)
    dp = mesh.n_data
    e_step = max(dp, cfg.episodes_per_step - cfg.episodes_per_step % dp)
    e_local = e_step // dp
    vf = virtual.features if cfg.embodied else None
    vc = virtual.counts if cfg.embodied else None
    key = prng.key(cfg.seed, device=table.features.device)
    accs, done = [], 0
    while done < cfg.n_episodes:
        local = eval_step(
            key, done + mesh.data_index * e_local, table.features,
            table.counts, vf, vc, n_way=cfg.n_way, k_shot=cfg.k_shot,
            n_query=cfg.n_query, n_step=e_local, metric=cfg.metric,
            fusion=cfg.fusion, matcher=cfg.matcher)
        acc = pdist.all_gather(local, mesh.data_group)  # [e_step], ordinals
        take = min(e_step, cfg.n_episodes - done)
        accs.append(acc[:take])
        done += take
    return eval_result(torch.cat(accs).cpu().numpy())
