"""Clip feature extraction: decode -> preprocess -> backbone -> store.

Counterpart of ``eov_tpu/extract.py`` (``ExtractConfig``,
``resolve_fused_stages``, ``quant_calibration``, ``make_feature_fn``,
``extract_features``).

* ``make_feature_fn`` builds the feature program, uint8 clips
  ``[B, K, H, W, 3]`` -> clip features ``[B, D]``: the fused crop+normalize
  (kernel 1) when frames are stored at the eval scale (``min(h, w) ==
  scale_size``, so the resize is the identity) and ``pallas_crop`` is on
  (the default), the resize path (``ops/preprocess.py``, what the
  reference's XLA route computes) otherwise;
  then the folded ResNet with fused stages (kernel 2 inside; kernel 4 on
  resnet18/34), the stem pool through kernel 6 (``pallas_pool=True``) or
  fused into the stage-1 stack (``"fused"``, kernel 5), optionally the
  space-to-depth stem (``stem_s2d``); or with ``quant="int8"`` the int8
  forward (``models/quant_infer.py``: stage 1 through kernel 7, the other
  convs as int8 im2col matmuls); then TSN mean consensus over the K
  segments.
* ``quant_calibration`` computes the int8 activation maxima once, on the
  deterministic synthetic fixtures or on the dataset's first clips, as
  plain floats under the reference's site names; the CLI records them in
  the store (``FeatureStore.set_quant_calib``) and classify reads them
  back, so queries go through the store's exact int8 program.
* ``extract_features`` runs it over a dataset into a ``FeatureStore``. A
  decode thread prepares the next batch while the device computes the
  current one; decode faults are skipped and logged; clips already in the
  store are skipped (resume); the store flushes every ``flush_every``
  clips. A dataset with a pooled ``get_batch`` (EOVC shards, video files)
  decodes each batch in one call into a buffer of a process-wide ring
  (page-locked when the batch goes to the GPU), which returns to the ring
  once the batch's features have materialized; other datasets, and runs
  under ``fault_inject``, decode record by record. ``records=`` restricts
  the work to those records; ``pad_batches`` pads a short tail batch to
  ``batch_clips`` by repeating its last clip, and the padded rows never
  reach the store.

``fold_bn=False`` runs the unfolded ResNet instead: each conv (its output
rounded to the compute dtype) then inference-mode BatchNorm in f32 from
the raw running statistics, the residual adds in f32, the reference's
``feature_apply(..., folded=False)``; the fused stages resolve to () there
(as the reference's do), so kernel 2 is off the path, while kernel 1 still
crops under ``pallas_crop`` and ``stem_s2d`` still applies (the 4x4 conv of
the refolded 7x7 kernel). int8 (and its calibration) needs the fold, and
``pallas_pool`` without it is refused, as below.

Under ``quant="int8"`` the fused stages resolve as the bf16 ones do:
``"auto"`` is ``(1,)`` on bottleneck archs, so stage 1 runs through kernel
7. The reference resolves ``"auto"`` to the pure int8 walk there, from a
TPU measurement that does not carry over; the kernel gives the walk's bits
(both are exact in int32 with the same roundings), so stores from either
program answer the same. ``fused_stages="none"`` gives the pure walk.

``ExtractConfig`` refuses at construction what the reference's
``make_feature_fn`` refuses at config time (``pallas_pool="fused"``
without stage 1 fused or on a basic arch; int8 with ``stem_s2d``). Where the reference only logs that it ignores
``pallas_pool`` (no fused stage resolved, or int8), the port raises
``ValueError`` instead: a flag that selects a kernel must not quietly run
another path. So on resnet18/34, whose ``"auto"`` fused stages are (),
``pallas_pool=True`` needs explicit ``fused_stages``. ``fused_group`` is
the reference's TPU grid knob (images per kernel grid step), whose results
are bit-identical for every group; the port accepts it and ignores it.

``extract_features(mesh=)`` is the multi-GPU loop (one process per GPU,
``parallel/``): each data row extracts its shard of the records into its
own namespace of the shared store, its frame ranks splitting the K
segments (``_extract_sharded``).
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
from collections import OrderedDict
from typing import Callable, Sequence

import numpy as np
import torch

from eov_tpu_torch.data.datasets import (VideoDataset, VideoRecord,
                                         get_batch_accepts_out)
from eov_tpu_torch.data.segments import center_indices_np
from eov_tpu_torch.data.store import FeatureStore
from eov_tpu_torch.models import get_arch
from eov_tpu_torch.models.folded_infer import (PALLAS_POOL, FoldedResNet,
                                               resolve_fused_stages,
                                               use_full_f32)
from eov_tpu_torch.models.quant_infer import (QuantResNet, calibrate_act_max,
                                              quantize_variables,
                                              resolve_quant_fused_stages,
                                              synthetic_calib_frames)
from eov_tpu_torch.models.fused_train import ResNetStem
from eov_tpu_torch.models.resnet import (ResNet, block_names,
                                         check_state_dict, fold_batchnorm,
                                         space_to_depth_stem)
from eov_tpu_torch.ops import preprocess
from eov_tpu_torch.ops.crop_normalize import crop_normalize
from eov_tpu_torch.utils import trace
from eov_tpu_torch.utils.debug import check_finite
from eov_tpu_torch.utils.device import resolve_device
from eov_tpu_torch.utils.metrics import MetricsWriter

__all__ = ["ExtractConfig", "resolve_fused_stages", "quant_calibration",
           "make_feature_fn", "make_segment_fn", "extract_features"]

log = logging.getLogger("eov_tpu_torch.extract")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ExtractConfig:
    num_segments: int = 8          # K segments per clip
    arch: str = "resnet50"
    batch_clips: int = 16          # clips per device batch
    scale_size: int = 256
    crop_size: int = 224
    compute_dtype: str = "bfloat16"
    fold_bn: bool = True           # fold inference BN into the convs; False
                                   # = conv then f32 BN from running stats
    fused_stages: tuple | str = "auto"  # "auto" = (1,) on bottleneck archs
                                        # (() without fold_bn)
    flush_every: int = 64          # clips per durable shard
    deterministic: bool = False    # decode inline, no overlap (tests)
    fault_inject: float = 0.0      # P(decode failure), failure-path tests
    fault_seed: int = 0
    quant: str | None = None       # None (bf16/f32 forward) | "int8"
    quant_calib_clips: int = 8     # calibration clips for the int8 scales
    quant_calib: str = "synthetic"  # "synthetic" fixtures | "dataset"
                                    # (the extraction dataset's first clips)
    pallas_pool: bool | str = False  # stem pool: False = cuDNN's max-pool,
                                     # True = kernel 6, "fused" = inside the
                                     # stage-1 stack (kernel 5); needs fused
                                     # stages, bf16/f32 forward only
    stem_s2d: bool = False         # space-to-depth stem (4x4 conv on
                                   # [H/2, W/2, 12]); bf16/f32 forward only
    pallas_crop: bool = True       # kernel 1 for frames stored at the eval
                                   # scale; False = the resize path
    fused_group: int = 2           # the reference's TPU grid knob; no-op
    pad_batches: bool = False      # pad the tail batch to batch_clips (the
                                   # padded rows are dropped before the store)

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(_DTYPES)}")
        if self.quant is not None and self.quant != "int8":
            raise ValueError(f"quant={self.quant!r}: the only implemented "
                             "scheme is 'int8'")
        if self.quant_calib not in ("synthetic", "dataset"):
            raise ValueError(f"quant_calib={self.quant_calib!r}: expected "
                             "'synthetic' or 'dataset'")
        if self.quant is not None and not self.fold_bn:
            raise ValueError(
                "quant='int8' quantizes the FOLDED inference path: it needs "
                "fold_bn=True")
        self._check_stem_options()

    def _check_stem_options(self) -> None:
        """The refusals of ``pallas_pool`` and ``stem_s2d``: the
        reference's, and two stricter ones where it only logs and ignores
        the flag (each names the flag to add or drop)."""
        pool = self.pallas_pool
        if pool not in PALLAS_POOL:
            raise ValueError(f"pallas_pool={pool!r}: expected one of "
                             f"{PALLAS_POOL}")
        if self.quant is not None:
            if self.stem_s2d:
                raise ValueError(
                    "quant='int8' composes with the standard stem only; the "
                    "s2d kernel rewrite reshapes conv1's input layout (set "
                    "stem_s2d=False)")
            if pool:
                raise ValueError(
                    f"quant='int8' with pallas_pool={pool!r}: the int8 "
                    "forward has no stem-pool kernel; drop --pallas-pool")
            return
        if pool and not self.fold_bn:
            raise ValueError(
                f"pallas_pool={pool!r} runs in the folded forward's fused "
                "stages; fold_bn=False has none (drop pallas_pool or keep "
                "fold_bn=True)")
        stages = resolve_fused_stages(self.fused_stages, arch=self.arch,
                                      folded=self.fold_bn)
        if pool and not stages:
            raise ValueError(
                f"pallas_pool={pool!r} needs a fused stage: fused_stages="
                f"{self.fused_stages!r} resolves to () on {self.arch}; add "
                "--fused-stages (e.g. 1,2,3,4) or drop --pallas-pool")
        if pool == "fused" and 1 not in stages:
            raise ValueError(
                "pallas_pool='fused' requires stage 1 in the resolved fused "
                f"stages (fused_stages={self.fused_stages!r} resolved to "
                f"{stages!r} on {self.arch}); use pallas_pool=True for the "
                "standalone kernel")
        if pool == "fused" and not get_arch(self.arch)[1]:
            raise ValueError(
                "pallas_pool='fused' is implemented for bottleneck archs "
                f"only (arch={self.arch!r}); use pallas_pool=True for the "
                "standalone kernel")


def _folded(weights, cfg: ExtractConfig) -> dict:
    """The folded weights; under int8, raw weights with BN statistics are
    required (the calibration and the quantization run on the fold)."""
    if cfg.quant is not None:
        try:
            check_state_dict(weights, cfg.arch, strict=False)
        except KeyError as e:
            raise ValueError(
                "quant='int8' quantizes the FOLDED inference path: it needs "
                f"raw weights with BatchNorm statistics ({e})") from None
    return fold_batchnorm(weights, cfg.arch)


def _synthetic_act_max(folded, cfg: ExtractConfig,
                       dev: torch.device) -> dict:
    """int8 activation maxima from the deterministic synthetic fixtures
    (the same clips in any environment)."""
    calib = synthetic_calib_frames(cfg.quant_calib_clips, cfg.num_segments,
                                   cfg.scale_size, cfg.scale_size)
    x = preprocess.preprocess_eval(torch.from_numpy(calib).to(dev),
                                   scale_size=cfg.scale_size,
                                   crop_size=cfg.crop_size,
                                   dtype=torch.float32)
    return calibrate_act_max(folded, x, arch=cfg.arch)


def quant_calibration(weights, cfg: ExtractConfig, dataset=None,
                      device: torch.device | str = "cuda") -> dict:
    """Per-conv-site int8 activation maxima as plain floats under the
    reference's site names: what a store records (``set_quant_calib``) so
    that query runs reproduce its exact int8 program.

    ``cfg.quant_calib``: ``"synthetic"`` (deterministic fixtures) or
    ``"dataset"`` (the first ``cfg.quant_calib_clips`` clips of
    ``dataset``, center-sampled and preprocessed as extraction does)."""
    dev = resolve_device(device)
    if not cfg.fold_bn:
        raise ValueError(
            "quant calibration runs over the FOLDED forward: it needs "
            "fold_bn=True and raw weights with BatchNorm statistics")
    resolve_quant_fused_stages(cfg.fused_stages, arch=cfg.arch)  # refusals
    folded = _folded(weights, dataclasses.replace(cfg, quant="int8"))
    if cfg.quant_calib == "dataset":
        if dataset is None:
            raise ValueError("quant_calib='dataset' needs the extraction "
                             "dataset")
        recs = list(dataset.records)[:cfg.quant_calib_clips]
        if not recs:
            raise ValueError("quant_calib='dataset': dataset has no records")
        xs = [preprocess.preprocess_eval(
            torch.from_numpy(dataset.get_frames(
                r, center_indices_np(r.num_frames, cfg.num_segments))).to(
                dev), scale_size=cfg.scale_size, crop_size=cfg.crop_size,
            dtype=torch.float32) for r in recs]
        act = calibrate_act_max(folded, torch.stack(xs), arch=cfg.arch)
    else:
        act = _synthetic_act_max(folded, cfg, dev)
    return {k: float(v) for k, v in act.items()}


def make_feature_fn(weights, cfg: ExtractConfig,
                    device: torch.device | str = "cuda",
                    act_max: dict | None = None) -> Callable:
    """uint8 clips [B, K, H, W, 3] (any device) -> features [B, D] float32
    on ``device``. ``weights`` is a torchvision-style state_dict
    (models.resnet).

    ``act_max`` (int8 only): the activation maxima to quantize with, e.g.
    ``quant_calibration``'s output or a store's ``quant_calib()``; None
    calibrates on the synthetic fixtures here."""
    segments = make_segment_fn(weights, cfg, device, act_max=act_max)

    @torch.inference_mode()
    def feature_fn(frames_u8: torch.Tensor) -> torch.Tensor:
        return check_finite("features", segments(frames_u8).mean(dim=1))

    return feature_fn


def make_segment_fn(weights, cfg: ExtractConfig,
                    device: torch.device | str = "cuda",
                    act_max: dict | None = None) -> Callable:
    """The feature program before the TSN consensus: uint8 clips [B, K, H,
    W, 3] -> per-segment features [B, K, D] float32 on ``device`` (what
    ``make_feature_fn`` averages, and what the sharded program sums over
    the frame ranks)."""
    dev = resolve_device(device)
    dtype = _DTYPES[cfg.compute_dtype]
    if dtype == torch.float32 and dev.type == "cuda":
        use_full_f32()
    if cfg.quant is not None:
        stages = resolve_quant_fused_stages(cfg.fused_stages, arch=cfg.arch)
        folded = _folded(weights, cfg)
        if act_max is None:
            act_max = _synthetic_act_max(folded, cfg, dev)
        try:
            qvars = quantize_variables(folded, act_max, cfg.arch)
        except KeyError as e:
            raise ValueError(
                f"calibration scales are missing conv site {e.args[0]!r} — "
                f"were they computed for a different --arch than "
                f"{cfg.arch!r}? Recompute with quant_calibration or drop "
                "act_max to recalibrate") from None
        net = QuantResNet(qvars, arch=cfg.arch, dtype=dtype,
                          fused_stages=stages)
    elif not cfg.fold_bn:
        net = UnfoldedResNet(weights, arch=cfg.arch, dtype=dtype,
                             stem_s2d=cfg.stem_s2d)
    else:
        if cfg.stem_s2d:
            weights = space_to_depth_stem(weights)
        net = FoldedResNet(fold_batchnorm(weights, cfg.arch), arch=cfg.arch,
                           dtype=dtype, fused_stages=cfg.fused_stages,
                           pallas_pool=cfg.pallas_pool,
                           stem_s2d=cfg.stem_s2d)
    net = net.to(dev).eval()

    @torch.inference_mode()
    def segment_fn(frames_u8: torch.Tensor) -> torch.Tensor:
        frames_u8 = frames_u8.to(dev, non_blocking=True)
        h, w = frames_u8.shape[-3], frames_u8.shape[-2]
        if cfg.pallas_crop and min(h, w) == cfg.scale_size:  # eval scale
            x = crop_normalize(frames_u8.contiguous(), crop=cfg.crop_size,
                               dtype=dtype)
        else:
            x = preprocess.preprocess_eval(
                frames_u8, scale_size=cfg.scale_size,
                crop_size=cfg.crop_size, dtype=dtype)
        return net(x).float()  # [B, K, D]

    return segment_fn


class UnfoldedResNet(torch.nn.Module):
    """The feature network without the BN fold (``fold_bn=False``): the
    train model ``models.resnet.ResNet`` in inference mode over the raw
    weights, frames ``[..., H, W, 3]`` -> features ``[..., D]`` f32. Its
    stem is ``models.fused_train.ResNetStem`` (the space-to-depth conv of
    the 7x7 kernel under ``stem_s2d``)."""

    def __init__(self, weights, *, arch: str = "resnet50",
                 dtype=torch.bfloat16, stem_s2d: bool = False):
        super().__init__()
        self.model = ResNet(arch, dtype=dtype)
        self.model.load_state_dict(check_state_dict(weights, arch,
                                                    strict=False))
        self.model.to(memory_format=torch.channels_last).eval()
        self.stem = ResNetStem(self.model, s2d=stem_s2d)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        lead = frames.shape[:-3]
        x = self.stem(frames.reshape(-1, *frames.shape[-3:]))
        for _, _, t in block_names(self.model.arch):
            x = self.model.run_block(t, x)
        return self.model.head(x).reshape(*lead, -1)


# Process-wide host input-buffer ring for the pooled decode, as the
# reference keeps it: fresh buffers of more than 32 MB are unmapped on free
# (glibc), so a new array per batch pays first-touch page faults every
# step, and a page-locked buffer is costly to allocate. Keyed by batch
# shape, at most _HOST_BUFS_CAP buffers a shape and _HOST_BUFS_SHAPES
# shapes (least recently used evicted), locked because the decode thread
# takes and the caller's thread puts back.
_HOST_BUFS: "OrderedDict[tuple, list]" = OrderedDict()
_HOST_BUFS_LOCK = threading.Lock()
_HOST_BUFS_CAP = 3  # buffers retained per batch shape
_HOST_BUFS_SHAPES = 4  # distinct shapes retained


def _take_buf(shape: tuple):
    with _HOST_BUFS_LOCK:
        stack = _HOST_BUFS.get(shape)
        if not stack:
            # An empty stack holds no stock but would take an LRU slot.
            if stack is not None:
                del _HOST_BUFS[shape]
            return None
        _HOST_BUFS.move_to_end(shape)
        buf = stack.pop()
        if not stack:
            del _HOST_BUFS[shape]
        return buf


def _put_buf(buf: np.ndarray) -> None:
    with _HOST_BUFS_LOCK:
        stack = _HOST_BUFS.setdefault(buf.shape, [])
        if len(stack) < _HOST_BUFS_CAP:
            stack.append(buf)
        _HOST_BUFS.move_to_end(buf.shape)
        while len(_HOST_BUFS) > _HOST_BUFS_SHAPES:
            _HOST_BUFS.popitem(last=False)


def _new_buf(shape: tuple, dev: torch.device) -> np.ndarray:
    """A ring buffer: page-locked once when batches go to the GPU (the
    array keeps its tensor, and so the page-locked memory, alive)."""
    if dev.type == "cuda":
        return torch.empty(shape, dtype=torch.uint8, pin_memory=True).numpy()
    return np.empty(shape, np.uint8)


def _host_batch(clips: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The decoded batch as a tensor, page-locked when it is bound for the
    GPU so the feature program's copy is asynchronous (a ring buffer
    already is; anything else is copied once)."""
    t = torch.from_numpy(clips)
    if dev.type == "cuda" and not t.is_pinned():
        t = t.pin_memory()
    return t


def extract_features(
    dataset: VideoDataset,
    weights,
    store: FeatureStore,
    cfg: ExtractConfig = ExtractConfig(),
    metrics: MetricsWriter | None = None,
    feature_fn: Callable | None = None,
    device: torch.device | str = "cuda",
    act_max: dict | None = None,
    records: Sequence[VideoRecord] | None = None,
    mesh=None,
) -> dict:
    """Extract every record not yet in the store. Returns stats
    {total, skipped_done, extracted, failed, report}; ``report`` is the
    pass's ``utils.trace`` report (the ``extract.pass`` root), also written
    in the ``extract_done`` event.

    ``feature_fn`` overrides the ResNet program (tests swap in a cheap
    one); ``act_max`` goes to ``make_feature_fn`` (int8 scales);
    ``records`` restricts the work list (default: all of the dataset's).

    ``mesh`` (a ``parallel.mesh.Mesh`` of more than one rank) runs the
    sharded loop (``_extract_sharded``): ``records`` defaults to this
    rank's shard, ``feature_fn`` to ``make_sharded_feature_fn`` (int8 needs
    ``act_max``), and ``store`` is the shared store opened with
    ``process_index`` = this rank's data index.
    """
    dev = resolve_device(device)
    metrics = metrics or MetricsWriter(None)
    if mesh is not None and mesh.size > 1:
        return _extract_sharded(dataset, weights, store, cfg, metrics,
                                feature_fn, dev, act_max, records, mesh)
    feature_fn = feature_fn or make_feature_fn(weights, cfg, dev,
                                               act_max=act_max)
    with trace.root("extract.pass", device=dev) as pass_span:
        stats = _extract(dataset, store, cfg, metrics, feature_fn, dev,
                         records)
    stats["report"] = pass_span.report
    metrics.write("extract_done", **stats)
    return stats


def _extract(dataset, store, cfg: ExtractConfig, metrics, feature_fn, dev,
             records) -> dict:
    done = store.done_ids()
    work = dataset.records if records is None else list(records)
    todo = [r for r in work if r.video_id not in done]
    fault_rng = np.random.default_rng(cfg.fault_seed)
    stats = {"total": len(work), "skipped_done": len(work) - len(todo),
             "extracted": 0, "failed": 0}
    since_flush = 0

    # Pooled decode: one get_batch call per batch. Whether it takes out=
    # (the buffer ring) is decided up front by its signature; where that
    # cannot be read (a C callable), the first call probes out= and a
    # TypeError settles on the out-less form for the rest of the run.
    can_pool = hasattr(dataset, "get_batch") and not cfg.fault_inject
    accepts_out = probe_out = False
    if can_pool:
        known = get_batch_accepts_out(dataset.get_batch)
        accepts_out = True if known is None else known
        probe_out = known is None
    clip_shape = None  # [K, H, W, 3] of the pooled batches, once seen

    def decode_pooled(batch):
        """-> (stacked uint8 clips, the ring buffer they are in or None)."""
        nonlocal accepts_out, probe_out, clip_shape
        idx = np.stack([center_indices_np(r.num_frames, cfg.num_segments)
                        for r in batch])
        buf = None
        if accepts_out and clip_shape is not None:
            shape = (len(batch), *clip_shape)
            buf = _take_buf(shape)
            if buf is None:
                buf = _new_buf(shape, dev)
        try:
            if not accepts_out:
                arr = dataset.get_batch(batch, idx)
            else:
                try:
                    arr = dataset.get_batch(batch, idx, out=buf)
                except TypeError as te:
                    if not probe_out:
                        raise  # raised inside an out-accepting loader
                    probe_out = accepts_out = False
                    # A TypeError from inside an out-accepting loader reads
                    # the same as a rejected out=; the warning says which
                    # was assumed.
                    log.warning(
                        "get_batch rejected out= (%s); settling on the "
                        "out-less pooled form — if this TypeError came "
                        "from inside an out-accepting loader, the buffer "
                        "ring is disabled for this run", te)
                    arr = dataset.get_batch(batch, idx)
                else:
                    probe_out = False
        except BaseException:
            if buf is not None:
                _put_buf(buf)
            raise
        if buf is not None and arr is not buf:
            _put_buf(buf)
            buf = None
        clip_shape = arr.shape[1:]
        return arr, buf

    def decode(batch):
        with trace.span("extract.decode"):
            return _decode(batch)

    def _decode(batch):
        """-> (batch size, [(records, stacked uint8 clips, ring buffer or
        None)], one group on the pooled path, else one per resolution)."""
        if can_pool:
            try:
                arr, buf = decode_pooled(batch)
                return len(batch), [(list(batch), arr, buf)]
            except Exception as e:  # noqa: BLE001 — retried per record
                log.warning("pooled decode failed (%s); per-record retry", e)
        groups: dict[tuple, tuple[list, list]] = {}
        for rec in batch:
            try:
                if cfg.fault_inject and fault_rng.random() < cfg.fault_inject:
                    raise IOError(f"injected decode fault: {rec.video_id}")
                idx = center_indices_np(rec.num_frames, cfg.num_segments)
                clip = dataset.get_frames(rec, idx)
            except Exception as e:  # noqa: BLE001 — containment by design
                stats["failed"] += 1
                log.warning("decode failed, skipping %s: %s", rec.video_id, e)
                metrics.write("decode_failure", video_id=rec.video_id,
                              error=str(e))
                continue
            g = groups.setdefault(clip.shape[1:3], ([], []))
            g[0].append(rec)
            g[1].append(clip)
        return len(batch), [(recs, np.stack(clips), None)
                            for recs, clips in groups.values()]

    def batches():
        for start in range(0, len(todo), cfg.batch_clips):
            yield todo[start:start + cfg.batch_clips]

    def decoded():
        """Decoded batches, prepared one ahead on a thread unless
        deterministic."""
        if cfg.deterministic:
            for b in batches():
                yield decode(b)
            return
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for b in batches():
                    if not put(decode(b)):
                        return
                put(None)
            except Exception as e:  # noqa: BLE001 — re-raised by the reader
                put(e)

        def take():
            while True:
                try:
                    return q.get(timeout=0.5)
                except queue.Empty:
                    if not t.is_alive():
                        raise RuntimeError("decode thread died") from None

        t = threading.Thread(target=producer, name="eov-decode", daemon=True)
        t.start()
        try:
            while True:
                with trace.span("extract.wait"):
                    item = take()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()

    def materialize(recs, feats_dev, buf):
        nonlocal since_flush
        with trace.span("extract.d2h", device=True):
            feats = feats_dev.cpu().numpy()
        if buf is not None:  # its batch's copy to the device is done
            _put_buf(buf)
        with trace.span("extract.store"):
            for rec, f in zip(recs, feats):
                store.put(rec.video_id, f, rec.label)
            stats["extracted"] += len(recs)
            trace.count("extract.images", len(recs) * cfg.num_segments)
            since_flush += len(recs)
            if since_flush >= cfg.flush_every:
                store.flush()
                since_flush = 0

    pending = None  # (records, features on device, ring buffer) in flight
    for n_batch, groups in decoded():
        n_ok = 0
        for recs, clips, buf in groups:
            if cfg.pad_batches and len(clips) < cfg.batch_clips:
                # Repeat the last clip up to the full batch; materialize's
                # zip(recs, feats) drops the padded rows.
                pad = np.repeat(clips[-1:], cfg.batch_clips - len(clips), 0)
                clips = np.concatenate([clips, pad])
                if buf is not None:  # the padded copy is what goes on
                    _put_buf(buf)
                    buf = None
            with trace.span("extract.features", device=True):
                feats = feature_fn(_host_batch(clips, dev))  # async on GPU
            if pending is not None:
                materialize(*pending)  # the previous batch drains meanwhile
            pending = (recs, feats, buf)
            n_ok += len(recs)
        metrics.write("extract_batch", n=n_ok, failed=n_batch - n_ok,
                      seconds=trace.step())
    if pending is not None:
        materialize(*pending)
    with trace.span("extract.store"):
        store.flush()
    return stats


def _extract_sharded(dataset, weights, store, cfg: ExtractConfig, metrics,
                     feature_fn, dev, act_max, records, mesh) -> dict:
    """The multi-GPU extraction loop (the reference's pod loop).

    Data row r holds ``records`` (default ``process_record_shard``: every
    n_data-th record from r); each of its frame ranks decodes the row's
    clips at its block of the K center segments. Every step has the fixed
    local batch ``batch_clips / n_data``, and every rank runs the same
    number of steps (``global_max``): a rank that has run out pads with
    its last clip, or a probe clip, so every rank enters the same
    collectives. A clip that fails to decode on any frame rank of the row
    is dropped on all of them. Frame rank 0 of each row writes the row's
    clips into the shared store (its ``process_index`` = the data index).
    Resume: the store's ``done_ids()``, read by every rank before any rank
    writes. A barrier closes the loop. Decoding is inline (no decode
    thread, no buffer ring); clips of another resolution than the rank's
    first are refused."""
    from eov_tpu_torch.parallel import distributed as pdist
    from eov_tpu_torch.parallel.sharded import make_sharded_feature_fn

    n_data = mesh.n_data
    if cfg.batch_clips % n_data:
        raise ValueError(f"global batch_clips={cfg.batch_clips} not "
                         f"divisible by data={n_data}")
    lb = cfg.batch_clips // n_data  # this row's clips of every step
    if lb == 0:
        raise ValueError(f"batch_clips={cfg.batch_clips} smaller than "
                         f"data={n_data}")
    seg = pdist.host_local_frames(mesh, cfg.num_segments)
    writer = mesh.frame_index == 0
    feature_fn = feature_fn or make_sharded_feature_fn(
        weights, mesh, cfg, act_max=act_max, device=dev)
    with trace.root("extract.pass", device=dev) as pass_span:
        stats = _sharded_pass(dataset, store, cfg, metrics, feature_fn, dev,
                              records, mesh, lb, seg, writer)
    stats["report"] = pass_span.report
    metrics.write("extract_done", **stats)
    return stats


def _sharded_pass(dataset, store, cfg: ExtractConfig, metrics, feature_fn,
                  dev, records, mesh, lb: int, seg, writer: bool) -> dict:
    from eov_tpu_torch.parallel import distributed as pdist

    k_local = len(range(cfg.num_segments)[seg])  # this rank's segments
    work = (pdist.process_record_shard(dataset.records, mesh)
            if records is None else list(records))
    done = store.done_ids()
    pdist.barrier()  # every rank has read done_ids before any writes
    todo = [r for r in work if r.video_id not in done]
    fault_rng = np.random.default_rng(cfg.fault_seed)
    stats = {"total": len(work), "skipped_done": len(work) - len(todo),
             "extracted": 0, "failed": 0}
    n_steps = pdist.global_max(-(-len(todo) // lb))
    can_pool = hasattr(dataset, "get_batch") and not cfg.fault_inject
    since_flush = 0
    known = None  # a clip of this rank's resolution, for the padding

    def indices(rec):
        return center_indices_np(rec.num_frames, cfg.num_segments)[seg]

    def decode(batch) -> list:
        """One uint8 clip [k_local, H, W, 3] or None (failed) a record."""
        if can_pool:
            try:
                arr = dataset.get_batch(batch, np.stack(
                    [indices(r) for r in batch]))
                return list(arr)
            except Exception as e:  # noqa: BLE001 — retried per record
                log.warning("pooled decode failed (%s); per-record retry", e)
        clips = []
        for rec in batch:
            try:
                if cfg.fault_inject and fault_rng.random() < cfg.fault_inject:
                    raise IOError(f"injected decode fault: {rec.video_id}")
                clips.append(dataset.get_frames(rec, indices(rec)))
            except Exception as e:  # noqa: BLE001 — containment by design
                log.warning("decode failed, skipping %s: %s", rec.video_id, e)
                metrics.write("decode_failure", video_id=rec.video_id,
                              error=str(e))
                clips.append(None)
        return clips

    pending = None  # (records, features on device) of the previous step
    for s in range(n_steps):
        batch = todo[s * lb:(s + 1) * lb]
        with trace.span("extract.decode"):
            clips = decode(batch)
        ok = torch.tensor([c is not None for c in clips] + [True] * (
            lb - len(clips)), dtype=torch.int32)
        if mesh.n_frame > 1:  # a clip counts only if every frame rank has it
            ok = pdist.all_reduce(ok, mesh.frame_group, op="min")
        good = [c for c, k in zip(clips, ok.tolist()) if c is not None and k]
        shapes = {c.shape for c in good} | (
            {known.shape} if known is not None else set())
        if len(shapes) > 1:
            raise ValueError(
                "multi-GPU extraction requires resolution-normalized frame "
                f"storage (saw {sorted(shapes)}); pack with pack_eovc "
                "--short-side")
        if good:
            known = good[-1]
        elif known is None:
            rec = (todo or work or list(dataset.records))[0]
            known = dataset.get_frames(rec, indices(rec))
        oks = [r for r, k in zip(batch, ok.tolist()) if k]
        stats["failed"] += len(batch) - len(oks)
        frames = np.stack(good + [known] * (lb - len(good)))
        with trace.span("extract.features", device=True):
            feats = feature_fn(_host_batch(frames, dev))
        if pending is not None:
            since_flush += _put_rows(store, *pending, writer, k_local)
        pending = (oks, feats)
        stats["extracted"] += len(oks)
        if since_flush >= cfg.flush_every:
            with trace.span("extract.store"):
                store.flush()
            since_flush = 0
        metrics.write("extract_batch", n=len(oks),
                      failed=len(batch) - len(oks), seconds=trace.step())
    if pending is not None:
        _put_rows(store, *pending, writer, k_local)
    with trace.span("extract.store"):
        store.flush()
    pdist.barrier()
    return stats


def _put_rows(store, recs, feats_dev, writer: bool, k: int) -> int:
    """Stage the rows of ``recs`` (the leading rows of ``feats_dev``) in
    the store when this rank writes; returns the rows staged. ``k``: this
    rank's segments a clip."""
    trace.count("extract.images", len(recs) * k)
    if not writer:
        return 0
    with trace.span("extract.d2h", device=True):
        feats = feats_dev.cpu().numpy()
    with trace.span("extract.store"):
        for rec, f in zip(recs, feats):
            store.put(rec.video_id, f, rec.label)
    return len(recs)
