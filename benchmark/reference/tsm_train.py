"""The first steps of TSM + non-local finetuning, in float32 (TF32 off).

As ``reference/train.py`` for TSN, through ``reference/tsm_nl.py``'s
network, under TSM's recipe: every BatchNorm trains on the batch's
statistics (``--npb``: no partial BN), so the trained leaves are every conv
kernel, every conv bias (the non-local blocks'), every BN's scale and
shift, and the fc layer; weight decay on the conv and fc kernels only (the
leaves of more than one dimension). The epoch's order, the TSN indices, the
step keys, the multiscale crop and the dropout draw are TSN's
(``reference/tsn.py``), at K = T segments.

``first_steps`` takes the planted faults of ``tsm_nl.forward`` (``shift``,
``nonlocal_``, ``batch_stats``), the training faults of
``reference/train.py`` (``rows_used``, ``epoch``, ``buf0``) and the
control's ``quant``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import resnet, tsm_nl, tsn
from benchmark.reference.shards import ShardSet


def trained(cfg: dict, params: dict) -> tuple[list[str], set[str]]:
    """(trained leaves, those with weight decay) among ``params``."""
    leaves = [n for n in params if n.endswith((".weight", ".bias"))]
    decay = {n for n in leaves if params[n].dim() > 1}
    return leaves, decay


def first_steps(p0: dict, cfg: dict, train: dict, shards: ShardSet,
                seed: int, device, *, n_steps: int = 3, quant=None,
                rows_used: int | None = None, epoch: int = 0,
                step0: int = 0, buf0: dict | None = None,
                shift: str = "on", nonlocal_: str = "on",
                batch_stats: bool = True) -> dict:
    """{'loss': [per step], 'grad': {leaf: first gradient}, 'delta':
    {leaf: change after n_steps}} on ``device``, for the first steps of
    ``epoch``, which starts at global step ``step0`` with SGD's momentum
    ``buf0`` (none before the first step). ``rows_used`` (a fault's
    reading) keeps only the leading clips of each batch, their batch
    statistics included."""
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
    d = resnet.blocks(cfg)[-1][3]
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
        noise = tsn.dropout_noise(keys[s], (b, k, d), device)[:u]
        for n in leaves:
            p[n].requires_grad_(True)
        logits = tsm_nl.forward(
            p, cfg, x.reshape(u * k, *x.shape[2:]), batch_stats=batch_stats,
            noise=noise.reshape(u * k, d), dropout=cfg["dropout"],
            quant=quant, shift_mode=shift, nl_mode=nonlocal_)
        loss = F.cross_entropy(logits.reshape(u, k, -1).mean(dim=1), labels)
        # a planted fault may leave leaves out of the graph: gradient 0
        grads = [torch.zeros_like(p[n]) if g is None else g
                 for n, g in zip(leaves, torch.autograd.grad(
                     loss, [p[n] for n in leaves], allow_unused=True))]
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
