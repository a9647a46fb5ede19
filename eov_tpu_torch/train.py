"""Meta-train finetune: TSN cross-entropy training of the backbone.

Counterpart of ``eov_tpu/train.py`` (reference component C12): finetune
the backbone on the meta-train classes before one-shot eval — K-segment
random TSN sampling, TSN multiscale-crop augmentation, consensus mean over
the segment LOGITS, softmax cross-entropy, SGD with momentum, weight decay
and a step-decayed learning rate — then score it by classification
(``evaluate_classifier``) and by meta-val one-shot episodes
(``one_shot_validate``, through the port's extract -> store -> eval).

One device (``cuda`` unless the caller asks for ``cpu``). The state is a
``TrainState`` holding the ``models.resnet.ResNet`` (parameters and BN
running statistics) and its ``torch.optim.SGD``; ``make_train_step``
returns a function that updates it in place and returns it.

The fused route: with ``partial_bn`` every stage BN is a constant affine,
so ResNet-50 stage 1 and the stride-1 tail of stage 2 (``layer2.1..``) run
as ``ops.bottleneck_train.bottleneck_stack_train`` (kernels 8 and 9 on the
GPU); the stem, ``layer2.0``, stages 3-4 and the head run as ordinary
PyTorch ops with autograd. ``fused_stage1``/``fused_stage2``: ``'auto'``
resolves to on for a bottleneck arch under ``partial_bn`` on a CUDA device
(the counterpart of the reference's on-TPU rule) and to off on the CPU;
``'on'`` forces the fused route (its plain versions on the CPU, for the
tests); ``'off'`` disables it.

Randomness: the augmentation draws with the port's bit-exact threefry
(``prng``), so the same step key crops the same clips as the reference.
The dropout mask cannot be the reference's (flax derives it through its own
RNG plumbing); it comes from a ``torch.Generator`` seeded from
``fold_in(step_key, 1)``.

The stem's two levers, on the fused route only as in the reference:
``stem_s2d='on'`` computes the stem conv by the space-to-depth rewrite of
its own 7x7 parameter (``models.fused_train._S2DConv1``; even crops only),
``pool_vjp='on'`` pools through ``ops.pool.maxpool_3x3_s2_vjp`` (the
reference's first-max backward). ``'auto'`` is off for both, as in the
reference. Neither changes the parameters, the checkpoint or the
optimizer.

Multi-GPU (``make_train_step(..., mesh=)``, ``train_epoch(mesh=)``; the
reference's pjit step and pod epoch loop): one process per GPU, each rank
on its block of the global batch (clips over 'data', segments over
'frame'), so that the global step equals the single-process step on the
global batch. Every rank draws the epoch's order and TSN indices from the
same seeded generator in global order and decodes its rows; the
augmentation keys are ``prng.split(key, B_global)`` and the dropout mask
is drawn at the global shape, each rank taking its rows; the trained stem
BN's statistics are averaged over every rank, and under ``n_frame > 1``
the segment logits are summed over the row's frame ranks, both through
autograd; the gradients are averaged over the ranks before SGD, and loss
and accuracy are global means. The state starts from rank 0's
(``sync_state``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from eov_tpu_torch import prng
from eov_tpu_torch.models import get_arch
from eov_tpu_torch.models.folded_infer import use_full_f32
from eov_tpu_torch.models.fused_train import (FusedStack, ResNetSlice,
                                              ResNetStem, stage_block_specs)
from eov_tpu_torch.models.resnet import (BatchNorm, Conv, ResNet,
                                         random_state_dict)
from eov_tpu_torch.ops import preprocess
from eov_tpu_torch.utils import debug, trace
from eov_tpu_torch.utils.debug import check_finite
from eov_tpu_torch.utils.device import resolve_device

__all__ = ["TrainConfig", "TrainState", "create_train_state",
           "make_train_step", "resolve_fused", "learning_rate",
           "train_epoch", "evaluate_classifier", "one_shot_validate",
           "sync_state"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TRI_STATE = ("fused_stage1", "fused_stage2", "stem_s2d", "pool_vjp")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_classes: int = 64             # Kinetics-100 CMN meta-train classes
    arch: str = "resnet50"
    num_segments: int = 3             # TSN train-time K
    batch_clips: int = 32             # clips per step
    lr: float = 0.001
    momentum: float = 0.9
    weight_decay: float = 5e-4
    lr_decay_steps: int = 1500        # step-decay interval
    lr_decay_rate: float = 0.1
    partial_bn: bool = True           # TSN: freeze every BN but the stem's
    dropout: float = 0.5              # before the fc head
    remat: bool = False               # recompute unfused blocks in backward
    augment: str = "multiscale"       # 'multiscale' | 'randomcrop'
    fused_stage1: str = "auto"        # 'auto' | 'on' | 'off' (see above)
    fused_stage2: str = "auto"        # stride-1 tail of stage 2
    stem_s2d: str = "auto"            # stem conv by space-to-depth; 'auto'
                                      # = off
    pool_vjp: str = "auto"            # stem pool with the first-max VJP;
                                      # 'auto' = off
    compute_dtype: str = "bfloat16"
    scale_size: int = 256
    crop_size: int = 224
    seed: int = 0


@dataclasses.dataclass
class TrainState:
    step: int                         # completed optimizer updates
    model: ResNet
    optimizer: torch.optim.SGD


def _validate(cfg: TrainConfig) -> None:
    """Reject unknown spellings: anything but the three tri-state words
    would otherwise mean OFF silently."""
    for f in _TRI_STATE:
        if getattr(cfg, f) not in ("auto", "on", "off"):
            raise ValueError(f"{f}={getattr(cfg, f)!r}: use 'auto', 'on', "
                             "or 'off'")
    if cfg.augment not in ("multiscale", "randomcrop"):
        raise ValueError(f"augment={cfg.augment!r}: use 'multiscale' or "
                         "'randomcrop'")
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {list(_DTYPES)}")


def resolve_fused(cfg: TrainConfig,
                  device: torch.device | str) -> tuple[bool, bool]:
    """(fuse stage 1, fuse the stage-2 tail) for ``cfg`` on ``device``;
    raises on impossible combinations, as the reference does."""
    _validate(cfg)
    bottleneck = get_arch(cfg.arch)[1]
    on_gpu = torch.device(device).type == "cuda"
    fuse = cfg.fused_stage1 == "on" or (
        cfg.fused_stage1 == "auto" and cfg.partial_bn and bottleneck
        and on_gpu)
    if fuse and not cfg.partial_bn:
        raise ValueError("fused_stage1='on' requires partial_bn=True "
                         "(frozen stage BNs)")
    if fuse and not bottleneck:
        raise ValueError(f"fused_stage1='on' requires a bottleneck arch, "
                         f"got {cfg.arch}")
    # 'auto' keys off the RESOLVED stage-1 decision.
    fuse2 = fuse and (cfg.fused_stage2 == "on"
                      or (cfg.fused_stage2 == "auto" and on_gpu))
    if cfg.fused_stage2 == "on" and not fuse:
        raise ValueError("fused_stage2='on' requires fused_stage1")
    for f in ("stem_s2d", "pool_vjp"):
        if getattr(cfg, f) == "on" and not fuse:
            raise ValueError(f"{f}='on' is implemented on the fused stem "
                             "path only (requires fused_stage1)")
    if cfg.stem_s2d == "on" and cfg.crop_size % 2:
        raise ValueError(f"stem_s2d='on' needs an even crop_size, got "
                         f"{cfg.crop_size}")
    return fuse, fuse2


def learning_rate(cfg: TrainConfig, step: int) -> float:
    """Staircase exponential decay over completed updates (optax
    ``exponential_decay(..., staircase=True)``)."""
    return cfg.lr * cfg.lr_decay_rate ** (step // cfg.lr_decay_steps)


def _param_groups(model: ResNet, cfg: TrainConfig) -> list[dict]:
    """TSN policy: weight decay on conv and fc kernels only; biases and the
    trainable BN affines undecayed; frozen BN affines (``requires_grad``
    off under partial_bn) in no group, so they never move."""
    decay, plain = [], []
    for mod in model.modules():
        if isinstance(mod, (Conv, torch.nn.Linear)):
            decay.append(mod.weight)
        if isinstance(mod, torch.nn.Linear):
            plain.append(mod.bias)
        if isinstance(mod, BatchNorm) and mod.weight.requires_grad:
            plain += [mod.weight, mod.bias]
    return [{"params": decay, "weight_decay": cfg.weight_decay},
            {"params": plain, "weight_decay": 0.0}]


def create_train_state(cfg: TrainConfig, device: torch.device | str = "cuda",
                       weights=None) -> TrainState:
    """Model and optimizer on ``device``. ``weights`` is a torchvision-named
    state_dict with the fc head (e.g. ``from_jax_variables`` of a flax
    train state); without it, seeded random weights (``cfg.seed``)."""
    _validate(cfg)
    dev = resolve_device(device)
    model = ResNet(cfg.arch, num_classes=cfg.num_classes,
                   dtype=_DTYPES[cfg.compute_dtype],
                   partial_bn=cfg.partial_bn, dropout=cfg.dropout,
                   remat=cfg.remat)
    if weights is None:
        weights = random_state_dict(cfg.arch, seed=cfg.seed,
                                    num_classes=cfg.num_classes)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()
                           if not k.endswith("num_batches_tracked")})
    model = model.to(dev).to(memory_format=torch.channels_last)
    opt = torch.optim.SGD(_param_groups(model, cfg), lr=cfg.lr,
                          momentum=cfg.momentum)
    return TrainState(step=0, model=model, optimizer=opt)


def make_train_step(cfg: TrainConfig, device: torch.device | str = "cuda",
                    mesh=None) -> Callable:
    """TSN train step ``(state, frames_u8 [B,K,H,W,3], labels [B], key) ->
    (state, {"loss", "accuracy"})`` on ``device``. ``key`` is a threefry key
    (``prng.key``); the metrics stay device tensors (no sync).

    With a ``parallel.mesh.Mesh`` of more than one rank, ``frames_u8`` and
    ``labels`` are this rank's block of the global batch (rows of its data
    index, segments of its frame index), ``key`` the global step's key, and
    the step is the global one (module doc); every rank must call it."""
    dev = resolve_device(device)
    sharded = mesh is not None and mesh.size > 1
    if sharded:
        from eov_tpu_torch.parallel import distributed as pdist
    fuse, fuse2 = resolve_fused(cfg, dev)
    dtype = _DTYPES[cfg.compute_dtype]
    if dev.type == "cuda":
        use_full_f32()  # the f32 resize and fc are full f32, as the reference
    aug = (preprocess.preprocess_train_multiscale
           if cfg.augment == "multiscale" else preprocess.preprocess_train)

    def forward(model: ResNet, flat, noise):
        if not fuse:
            return model(flat, noise)
        sizes = model.stage_sizes
        width = model.conv1.weight.shape[0]
        x = ResNetStem(model, s2d=cfg.stem_s2d == "on",
                       pool_vjp=cfg.pool_vjp == "on")(flat)
        x = FusedStack(model, [f"layer1.{j}" for j in range(sizes[0])])(x)
        if fuse2:
            x = model.run_block("layer2.0", x)
            x = FusedStack(model, [f"layer2.{j}"
                                   for j in range(1, sizes[1])])(x)
        rest = stage_block_specs(sizes, width, (3, 4) if fuse2 else (2, 3, 4))
        return ResNetSlice(model, rest, head=True)(x, noise)

    def train_step(state: TrainState, frames_u8: torch.Tensor,
                   labels: torch.Tensor, key: torch.Tensor):
        with trace.span("train.step"):
            return _step(state, frames_u8, labels, key)

    def _step(state, frames_u8, labels, key):
        model, opt = state.model, state.optimizer
        model.train()
        with trace.span("train.h2d", device=True):
            frames = frames_u8.to(dev, non_blocking=True)
            labels = labels.to(dev, torch.int64, non_blocking=True)
        b, k = frames.shape[0], frames.shape[1]
        trace.count("train.images", b * k)
        bg, kg = b, k  # the global batch, of which this rank has a block
        rows = segs = slice(None)
        if sharded:
            bg, kg = b * mesh.n_data, k * mesh.n_frame
            rows = pdist.host_local_rows(mesh, bg)
            segs = pdist.host_local_frames(mesh, kg)
        with trace.span("train.augment", device=True):
            with trace.span("train.keys"):
                key = key.cpu()
                keys = prng.split(key, bg)[rows]
            # the crop draws: a train.keys span after the resize's launch
            x = aug(keys, frames, scale_size=cfg.scale_size,
                    crop_size=cfg.crop_size, dtype=dtype)
            noise = None
            if cfg.dropout > 0:  # drawn at the global shape; this rank's
                with trace.span("train.keys"):
                    hi, lo = prng.fold_in(key, 1).tolist()
                gen = torch.Generator(device=dev)
                gen.manual_seed((hi << 32) | lo)
                noise = torch.rand((bg, kg, model.fc.in_features),
                                   generator=gen, device=dev)[
                    rows, segs].reshape(b * k, -1)
        with _global_bn_stats(model, mesh if sharded else None):
            with trace.span("train.forward", device=True):
                logits = forward(model, x.reshape(b * k, *x.shape[2:]),
                                 noise)
                logits = logits.reshape(b, k, -1)
                if sharded and mesh.n_frame > 1:  # TSN consensus, the row
                    logits = pdist.all_reduce_grad(
                        logits.sum(dim=1), mesh.frame_group) / kg
                else:
                    logits = logits.mean(dim=1)  # TSN consensus
                loss = check_finite("train loss",
                                    F.cross_entropy(logits, labels))
                acc = (logits.argmax(dim=-1) == labels).float().mean()
            with trace.span("train.backward", device=True):
                opt.zero_grad(set_to_none=True)
                loss.backward()
        if sharded:
            with trace.span("train.allreduce", device=True):
                _mean_grads(model, mesh.size)
                loss, acc = (pdist.all_reduce(
                    torch.stack([loss.detach(), acc])) / mesh.size).unbind(0)
        if debug.enabled():
            for name, p in model.named_parameters():
                if p.grad is not None:
                    check_finite(f"gradient of {name}", p.grad)
        with trace.span("train.optimizer", device=True):
            for group in opt.param_groups:
                group["lr"] = learning_rate(cfg, state.step)
            opt.step()
        state.step += 1
        return state, {"loss": loss.detach(), "accuracy": acc}

    return train_step


@contextlib.contextmanager
def _global_bn_stats(model: ResNet, mesh):
    """With a mesh, the training BNs (the stem's alone under partial_bn)
    use their batch statistics averaged over every rank, through autograd,
    until the block ends: the forward and the backward, where remat
    recomputes the blocks. Without one, nothing changes."""
    if mesh is None:
        yield
        return
    from eov_tpu_torch.parallel import distributed as pdist

    def reduce(t):
        return pdist.all_reduce_grad(t) / mesh.size

    bns = [m for m in model.modules()
           if isinstance(m, BatchNorm) and not m.frozen]
    for m in bns:
        m.stats_reduce = reduce
    try:
        yield
    finally:
        for m in bns:
            m.stats_reduce = None


def _mean_grads(model: torch.nn.Module, world: int) -> None:
    """Every parameter gradient replaced by its mean over the ranks (one
    all-reduce of the flattened gradients)."""
    from eov_tpu_torch.parallel import distributed as pdist

    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = pdist.all_reduce(torch.cat([g.reshape(-1) for g in grads])) / world
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def sync_state(state: TrainState) -> TrainState:
    """Rank 0's parameters, buffers and momentum on every rank (a no-op
    without a process group)."""
    from eov_tpu_torch.parallel import distributed as pdist

    model = state.model
    tensors = [*model.parameters(), *model.buffers()]
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                tensors.append(buf)
    pdist.broadcast_tensors(tensors)
    return state


def evaluate_classifier(state: TrainState, cfg: TrainConfig, dataset, *,
                        batch_clips: int | None = None) -> dict:
    """Video-level top-1 of the finetuned model: center TSN sampling of K
    segments, running-statistics BN, consensus mean over segment logits
    (the reference's test protocol)."""
    from eov_tpu_torch.data.segments import center_indices_np

    model = state.model
    dev = next(model.parameters()).device
    dtype = _DTYPES[cfg.compute_dtype]
    model.eval()
    bc = batch_clips or cfg.batch_clips
    correct = total = 0
    recs = list(dataset.records)
    with torch.inference_mode():
        for start in range(0, len(recs), bc):
            # Group by frame resolution (mixed-resolution datasets); the
            # protocol is per clip, so grouping never changes the result.
            groups: dict[tuple, tuple[list, list]] = {}
            for r in recs[start:start + bc]:
                clip = dataset.get_frames(
                    r, center_indices_np(r.num_frames, cfg.num_segments))
                g = groups.setdefault(clip.shape[1:3], ([], []))
                g[0].append(clip)
                g[1].append(r.label)
            for clips, labels in groups.values():
                frames = torch.from_numpy(np.stack(clips)).to(dev)
                b, k = frames.shape[0], frames.shape[1]
                x = preprocess.preprocess_eval(
                    frames, scale_size=cfg.scale_size,
                    crop_size=cfg.crop_size, dtype=dtype)
                logits = model(x.reshape(b * k, *x.shape[2:]))
                preds = logits.reshape(b, k, -1).mean(dim=1).argmax(dim=-1)
                correct += int((preds.cpu().numpy()
                                == np.asarray(labels)).sum())
                total += len(labels)
    return {"top1": correct / max(total, 1), "n": total}


def one_shot_validate(state: TrainState, cfg: TrainConfig, dataset, *,
                      n_way: int = 5, k_shot: int = 1, n_query: int = 1,
                      n_episodes: int = 120, num_segments: int = 8,
                      batch_clips: int | None = None, seed: int = 0):
    """Meta-val one-shot accuracy of the current state (the reference's
    model-selection rule): the production extract -> store -> eval chain
    over ``dataset`` (the meta-val classes) with the state's weights,
    eval-time center sampling of ``num_segments``, through a throwaway
    store. Returns the ``EvalResult``."""
    import tempfile

    from eov_tpu_torch.data.store import FeatureStore
    from eov_tpu_torch.eval import EvalConfig, evaluate
    from eov_tpu_torch.extract import ExtractConfig, extract_features

    dev = next(state.model.parameters()).device
    ecfg = ExtractConfig(num_segments=num_segments, arch=cfg.arch,
                         batch_clips=batch_clips or cfg.batch_clips,
                         scale_size=cfg.scale_size, crop_size=cfg.crop_size,
                         compute_dtype=cfg.compute_dtype, deterministic=True)
    weights = {k: v.detach() for k, v in state.model.state_dict().items()}
    with tempfile.TemporaryDirectory() as tmp:
        store = FeatureStore(tmp, class_names=list(dataset.class_names),
                             quant=None)
        extract_features(dataset, weights, store, ecfg, device=dev)
        table = store.to_table(dev)
    evc = EvalConfig(n_way=n_way, k_shot=k_shot, n_query=n_query,
                     n_episodes=n_episodes,
                     episodes_per_step=min(64, n_episodes), seed=seed)
    return evaluate(table, evc)


def _tsn_train_indices(rng, num_frames: int, k: int) -> np.ndarray:
    """TSN train-rule sampling: one random frame per equal segment; short
    clips draw k sorted random frames."""
    avg = num_frames // k
    if avg > 0:
        return np.arange(k) * avg + rng.integers(0, avg, size=k)
    return np.sort(rng.integers(0, num_frames, size=k))


def train_epoch(state: TrainState, step_fn: Callable, cfg: TrainConfig,
                dataset, *, epoch: int = 0, mesh=None) -> tuple:
    """One epoch over ``dataset``: the reference's single-process loop.

    The order and the TSN indices come from ``default_rng(seed + epoch)``,
    the step keys from ``prng.key(seed + epoch)`` split once per step, so
    the port feeds the reference's batches with the reference's keys. Clips
    are bucketed per frame resolution and a step runs whenever a bucket
    fills; a bucket's tail is wrap-padded to a full batch.

    The clips are read on the calling thread, one batch ahead of the step;
    a thread (``_Stacker``) stacks each batch, page-locked when the state
    is on a GPU, while the step before it runs. It is joined before the
    function returns or raises.

    Returns (state, {"loss", "accuracy", "steps", "clips", "report"}):
    ``report`` is the epoch's ``utils.trace`` report (the ``train.epoch``
    root: seconds per span, counters, device gaps).

    With a mesh of more than one rank (``step_fn`` from
    ``make_train_step(mesh=)``): the reference's pod loop (``_epoch_sharded``).
    """
    if mesh is not None and mesh.size > 1:
        return _epoch_sharded(state, step_fn, cfg, dataset, epoch, mesh)
    dev = next(state.model.parameters()).device
    with trace.root("train.epoch", epoch, dev) as epoch_span:
        state, out = _epoch(state, step_fn, cfg, dataset, epoch, dev)
    out["report"] = epoch_span.report
    return state, out


def _samples(cfg: TrainConfig, dataset, epoch: int) -> list:
    """The epoch's (record, TSN indices) in order: the permutation, then
    each clip's indices, from one generator, as the reference draws them
    between its reads."""
    rng = np.random.default_rng(cfg.seed + epoch)
    recs = [dataset.records[i] for i in rng.permutation(len(dataset.records))]
    return [(r, _tsn_train_indices(rng, r.num_frames, cfg.num_segments))
            for r in recs]


def _bucketed(dataset, samples: list, b: int):
    """The single-process epoch's batches in order, as (clips, labels,
    clips read): a batch whenever a resolution's bucket fills, then each
    bucket's tail wrap-padded, in the order the buckets first appeared."""
    buckets: dict[tuple, tuple[list, list]] = {}
    for r, idx in samples:
        clip = dataset.get_frames(r, idx)
        hw = clip.shape[1:3]
        clips, labels = buckets.setdefault(hw, ([], []))
        clips.append(clip)
        labels.append(r.label)
        if len(clips) == b:
            yield clips, labels, b
            buckets[hw] = ([], [])  # keeps the bucket's place in the order
    for clips, labels in buckets.values():
        if not clips:
            continue
        n0 = len(clips)
        for j in range(b - n0):  # wrap-pad the tail
            clips.append(clips[j % n0])
            labels.append(labels[j % n0])
        yield clips, labels, n0


class _Steps:
    """The loop's side of the stacking thread: ``run()`` takes the oldest
    batch handed over, splits the step key and runs the step."""

    def __init__(self, ring, step_fn: Callable, state, key):
        self.ring, self.step_fn, self.state, self.key = (ring, step_fn,
                                                         state, key)
        self.last: dict = {}
        self.steps = 0

    def run(self) -> None:
        with trace.span("train.batch"):
            frames, labels, _ = self.ring.take()
            self.key, sub = prng.split(self.key, 2).unbind(0)
            labels = torch.tensor(labels, dtype=torch.int64)
        self.state, self.last = self.step_fn(self.state, frames, labels, sub)
        trace.step()
        self.steps += 1


def _epoch(state: TrainState, step_fn: Callable, cfg: TrainConfig, dataset,
           epoch: int, dev: torch.device) -> tuple:
    n_clips = 0
    samples = _samples(cfg, dataset, epoch)
    with _Stacker(dev) as ring:
        steps = _Steps(ring, step_fn, state, prng.key(cfg.seed + epoch))
        for clips, labels, n in _bucketed(dataset, samples, cfg.batch_clips):
            n_clips += n
            ring.put(clips, labels, n)
            if ring.pending > 1:  # it stacks while the batch before it steps
                steps.run()
        while ring.pending:
            steps.run()
    out = {k: float(v) for k, v in steps.last.items()}
    out.update(steps=steps.steps, clips=n_clips)
    return steps.state, out


def _epoch_sharded(state: TrainState, step_fn: Callable, cfg: TrainConfig,
                   dataset, epoch: int, mesh) -> tuple:
    """The multi-GPU epoch: the single-process epoch's global batches, each
    rank decoding its block of them.

    Every rank draws the permutation and every TSN index from the same
    seeded generator in global order, and wrap-pads the tail, so global
    batch s is the single-process epoch's s-th batch; data rank r decodes
    rows [r * b_local, (r + 1) * b_local) of each, at its frame rank's
    segments. The ranks agree on the frame resolution before the first
    step; a dataset of several resolutions is refused (a rank cannot see
    the others' frames, so the single-process bucketing has no sharded
    form). The state starts from rank 0's."""
    dev = next(state.model.parameters()).device
    with trace.root("train.epoch", epoch, dev) as epoch_span:
        state, out = _sharded(state, step_fn, cfg, dataset, epoch, mesh, dev)
    out["report"] = epoch_span.report
    return state, out


def _sharded(state: TrainState, step_fn: Callable, cfg: TrainConfig, dataset,
             epoch: int, mesh, dev: torch.device) -> tuple:
    from eov_tpu_torch.parallel import distributed as pdist

    b = cfg.batch_clips
    rows = pdist.host_local_rows(mesh, b)
    segs = pdist.host_local_frames(mesh, cfg.num_segments)
    with trace.span("train.allreduce", device=True):
        state = sync_state(state)
    samples = _samples(cfg, dataset, epoch)
    n = len(samples)
    n0 = n % b
    if n0:
        tail = samples[n - n0:]
        samples += [tail[j % n0] for j in range(b - n0)]
    shape0 = None
    with _Stacker(dev) as ring:
        steps = _Steps(ring, step_fn, state, prng.key(cfg.seed + epoch))
        for s in range(len(samples) // b):
            clips, labels = [], []
            for r, idx in samples[s * b:(s + 1) * b][rows]:
                clip = dataset.get_frames(r, idx[segs])
                if shape0 is None:
                    shape0 = clip.shape[1:3]
                elif clip.shape[1:3] != shape0:
                    raise ValueError(
                        "multi-GPU training requires resolution-normalized "
                        f"storage: saw {clip.shape[1:3]} after {shape0} — "
                        "pack to EOVC (tools/pack_eovc) or pre-resize")
                clips.append(clip)
                labels.append(r.label)
            if s == 0:
                code = shape0[0] * 131072 + shape0[1]
                if pdist.global_max(code) != -pdist.global_max(-code):
                    raise ValueError(
                        "multi-GPU training: the ranks decoded different "
                        f"frame resolutions (this rank: {shape0}) — "
                        "resolution-normalize the storage (pack_eovc)")
            ring.put(clips, labels, len(clips))
            if ring.pending > 1:
                steps.run()
        while ring.pending:
            steps.run()
    out = {k: float(v) for k, v in steps.last.items()}
    out.update(steps=steps.steps, clips=n)
    return steps.state, out


class _Stacker:
    """``with _Stacker(dev) as ring:`` a thread (``eov-train-prefetch``)
    that stacks each batch ``ring.put(clips, labels, count)`` hands it,
    and page-locks it when the batches go to a GPU (a block of PyTorch's
    page-locked pool, reused once the step's copy out of it is done), so
    that the step's copy is asynchronous. ``ring.take()`` gives the oldest
    as (frames, labels, count) and raises what the thread raised. Leaving
    the block stops and joins the thread.

    The reads stay on the loop's thread: they hold the interpreter's lock
    nearly throughout, and a thread that waits for the lock makes every
    small tensor operation of the lock's holder cost a wake-up. The stack
    and the page-locked copy are one call each, which releases it."""

    def __init__(self, dev: torch.device):
        self._pin = dev.type == "cuda"
        self._in: queue.SimpleQueue = queue.SimpleQueue()
        self._out: queue.SimpleQueue = queue.SimpleQueue()
        self.pending = 0  # handed over, not yet taken
        self._thread = threading.Thread(target=self._stack,
                                        name="eov-train-prefetch",
                                        daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._in.put(None)
        self._thread.join()
        return False

    def _stack(self) -> None:
        while (item := self._in.get()) is not None:
            clips, labels, n = item
            try:
                # one call each, so the lock is taken back twice a batch
                frames = torch.stack([torch.from_numpy(c) for c in clips])
                if self._pin:
                    frames = frames.pin_memory()
                self._out.put((frames, labels, n))
            except Exception as e:  # noqa: BLE001 — raised again by take()
                self._out.put(e)

    def put(self, clips: list, labels: list, n: int) -> None:
        self._in.put((clips, labels, n))
        self.pending += 1

    def take(self) -> tuple:
        try:
            item = self._out.get_nowait()
            ready = True
        except queue.Empty:
            ready = False
            while True:
                try:
                    item = self._out.get(timeout=0.5)
                    break
                except queue.Empty:
                    if not self._thread.is_alive() and self._out.empty():
                        raise RuntimeError(
                            "the train prefetch thread died") from None
        self.pending -= 1
        if isinstance(item, Exception):
            raise item
        trace.count("train.prefetch.batches")
        if ready:
            trace.count("train.prefetch.ready")
        return item
