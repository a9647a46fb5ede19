"""The first steps of TSN finetuning, in float32 (TF32 off).

``first_steps`` follows the program through the first ``n_steps`` global
steps of ``batch`` clips of an epoch from given weights (and momentum, for
an epoch after the first): each step's mean
cross-entropy of the segment-averaged logits, the first step's gradient of
every trained leaf, and each trained leaf's change after the last step,
under SGD with momentum, weight decay on the conv and fc kernels only, and
the step-decayed learning rate. Trained leaves under partial BN: every conv
kernel, the stem BN's scale and shift, the fc layer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import resnet, tsn
from benchmark.reference.shards import ShardSet


def trained(cfg: dict, names) -> tuple[list[str], set[str]]:
    """(trained leaves, those with weight decay) among ``names``."""
    leaves = [n for n in names
              if n.endswith(".weight") and (".conv" in n or n.startswith(
                  "conv1") or ".downsample.0" in n)
              or n in ("bn1.weight", "bn1.bias", "fc.weight", "fc.bias")]
    decay = {n for n in leaves if n not in ("bn1.weight", "bn1.bias",
                                            "fc.bias")}
    return leaves, decay


def first_steps(p0: dict, cfg: dict, train: dict, shards: ShardSet,
                seed: int, device, *, n_steps: int = 3, quant=None,
                rows_used: int | None = None, epoch: int = 0,
                step0: int = 0, buf0: dict | None = None) -> dict:
    """{'loss': [per step], 'grad': {leaf: first gradient}, 'delta':
    {leaf: change after n_steps}} on ``device``, for the first steps of
    ``epoch``, which starts at global step ``step0`` with SGD's momentum
    ``buf0`` (none before the first step). ``rows_used`` (a fault's
    reading) keeps only the leading clips of each batch."""
    resnet.no_tf32()
    k, b = cfg["train_segments"], train["batch_clips"]
    plan = tsn.epoch_plan(len(shards.records),
                          [r[4] for r in shards.records], k, seed, epoch)
    if len(plan) < n_steps * b:
        raise ValueError(f"epoch {epoch} holds {len(plan)} clips, fewer "
                         f"than {n_steps} steps of {b}")
    keys = tsn.step_keys(seed, epoch, n_steps)
    p = {n: t.detach().clone().to(device) for n, t in p0.items()}
    leaves, decay = trained(cfg, p)
    buf = {n: t.to(device) for n, t in (buf0 or {}).items()}
    losses, grad1 = [], {}
    remat = b * k > 128
    for s in range(n_steps):
        u = rows_used or b
        rows = plan[s * b:(s + 1) * b][:u]
        frames = torch.from_numpy(np.stack(
            [shards.frames(i, idx) for i, idx in rows])).to(device)
        labels = torch.tensor([shards.label(i) for i, _ in rows],
                              device=device)
        x = tsn.train_preprocess(frames, keys[s].to(device), b,
                                 scale=cfg["scale_size"],
                                 crop=cfg["crop_size"])
        d = resnet.blocks(cfg)[-1][3]
        noise = tsn.dropout_noise(keys[s], (b, k, d), device)[:u]
        for n in leaves:
            p[n].requires_grad_(True)
        logits = resnet.forward(
            p, cfg, x.reshape(u * k, *x.shape[2:]), train_stem_bn=True,
            noise=noise.reshape(u * k, d), dropout=cfg["dropout"],
            quant=quant, remat=remat)
        loss = F.cross_entropy(logits.reshape(u, k, -1).mean(dim=1), labels)
        grads = torch.autograd.grad(loss, [p[n] for n in leaves])
        losses.append(float(loss.detach()))
        lr = cfg["lr"] * cfg["lr_decay_rate"] ** (
            (step0 + s) // cfg["lr_decay_steps"])
        with torch.no_grad():
            for n, g in zip(leaves, grads):
                p[n].requires_grad_(False)
                if s == 0:
                    grad1[n] = g.detach().clone()
                dp = g + cfg["weight_decay"] * p[n] if n in decay else g
                buf[n] = dp.clone() if n not in buf else (
                    cfg["momentum"] * buf[n] + dp)
                p[n] -= lr * buf[n]
        del logits, loss, grads, x, frames
    delta = {n: p[n] - p0[n].to(device) for n in leaves}
    return {"loss": losses, "grad": grad1, "delta": delta}
