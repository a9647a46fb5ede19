"""TSN clip features in float32 (TF32 off): the centre frame of each of K
segments, centre-cropped and normalized, through the backbone without its
head (BN on its running statistics), mean-pooled, then averaged over the
K segments."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import resnet, tsn
from benchmark.reference.shards import ShardSet


@torch.no_grad()
def features(p: dict, cfg: dict, shards: ShardSet, recs, device, *,
             k: int, chunk: int = 16,
             segments_used: int | None = None) -> torch.Tensor:
    """[len(recs), D] float32 on ``device``. ``segments_used`` (a fault's
    reading) averages only the leading segments."""
    resnet.no_tf32()
    out = []
    for a in range(0, len(recs), chunk):
        clips = np.stack([shards.frames(r, tsn.center_indices(
            shards.records[r][4], k)) for r in recs[a:a + chunk]])
        x = tsn.eval_preprocess(torch.from_numpy(clips).to(device),
                                scale=cfg["scale_size"],
                                crop=cfg["crop_size"])
        n = x.shape[0]
        f = resnet.forward(p, cfg, x.reshape(n * k, *x.shape[2:]),
                           head=False)
        out.append(f.reshape(n, k, -1)[:, :segments_used or k].mean(dim=1))
    return torch.cat(out)
