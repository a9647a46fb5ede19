"""``tsm_nl_resnet50`` on the CPU against the plain float32 reference
(``benchmark/reference/tsm_nl.py``, ``tsm_train.py``), at small shapes and
the published widths: 32x32 crops, T = 4 segments, 2 clips.

The shift is a copy, so its plain version equals the reference's exactly
and its gradient is its adjoint exactly. The rest runs in float32 on both
sides and differs by summation order only (CPU convolutions, SDPA's math
path against a matmul and a softmax): 1e-4 relative bounds the outputs and
the loss with room (the train step's loss reads 4e-7), while the bf16
program misses it (its loss reads 1.1e-2).
Then the refusals, a ResNet-50 bottleneck that runs no shift, the
published init's identity block, and a timed span's device seconds.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from benchmark import data as bm_data
from benchmark.reference import tsm_nl, tsm_train
from benchmark.reference.shards import ShardSet
from eov_tpu_torch import train as tr
from eov_tpu_torch.data.datasets import EovcVideoDataset
from eov_tpu_torch.extract import ExtractConfig, make_feature_fn
from eov_tpu_torch.models import resnet
from eov_tpu_torch.ops.temporal_shift import shift_plain, temporal_shift
from eov_tpu_torch.utils import trace

ARCH = "tsm_nl_resnet50"
T = 4
SEED = 2 ** 31 + 77
REL = 1e-4
# A gradient by leaf, elementwise: float32 on both sides reads 3.3e-4 at the
# median leaf and 1.4e-3 at the worst (the batch-statistics BNs over a few
# pixels of 2x2 and 1x1 maps amplify a rounding); the bf16 program reads 0.41
# at the median leaf.
GRAD_REL = 5e-3
CFG_FILE = os.path.join(os.path.dirname(__file__), "..", "benchmark",
                        "configs", "tsm_nl_resnet50.json")


def _cfg(**kw) -> dict:
    with open(CFG_FILE) as f:
        cfg = json.load(f)
    cfg.update(train_segments=T, scale_size=40, crop_size=32,
               num_classes=3, **kw)
    return cfg


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


# -- the shift ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 24])
def test_shift_plain_equals_reference(dtype, c):
    x = torch.randn(2 * T, c, 3, 5).to(dtype).contiguous(
        memory_format=torch.channels_last)
    got = shift_plain(x, T, c // 8)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, tsm_nl.shift(x, T, c // 8))
    assert torch.equal(shift_plain(x, T, c // 8, reverse=True),
                       tsm_nl.shift(x, T, c // 8, "swapped"))


@pytest.mark.parametrize("c", [64, 256])
def test_shift_adjoint(c):
    """<shift x, y> = <x, shift* y>, and autograd's gradient is shift* y."""
    g = torch.Generator().manual_seed(c)
    x = torch.randn(3 * T, c, 4, 4, generator=g, dtype=torch.float64)
    y = torch.randn(3 * T, c, 4, 4, generator=g, dtype=torch.float64)
    fold = c // 8
    lhs = (shift_plain(x, T, fold) * y).sum()
    rhs = (x * shift_plain(y, T, fold, reverse=True)).sum()
    assert abs(float(lhs - rhs)) <= 1e-12 * float(x.abs().sum())
    xr = x.clone().requires_grad_(True)
    (temporal_shift(xr, T, fold) * y).sum().backward()
    assert torch.equal(xr.grad, shift_plain(y, T, fold, reverse=True))


# -- one non-local block -------------------------------------------------------

@pytest.mark.parametrize("training", [True, False])
def test_nonlocal_block_matches_reference(training):
    """A res3 block (C 512, Ci 256) on [2 clips x T, 512, 4, 4]."""
    cfg = _cfg()
    p = tsm_nl.make_weights(cfg, SEED, "cpu")
    name = "layer2.0"
    g = torch.Generator().manual_seed(3)
    for k in ("running_mean", "running_var"):
        p[f"{name}.nl.bn.{k}"] = torch.rand(512, generator=g) + 0.5
    for c in tsm_nl.NL_CONVS:
        p[f"{name}.nl.{c}.bias"] = 0.1 * torch.randn(
            p[f"{name}.nl.{c}.bias"].shape, generator=g)
    block = resnet.NonLocal(512, T, torch.float32, frozen=False)
    block.load_state_dict({k[len(name) + 4:]: v for k, v in p.items()
                           if k.startswith(f"{name}.nl.")})
    block.train(training)
    z = torch.relu(torch.randn(2 * T, 512, 4, 4, generator=g)).contiguous(
        memory_format=torch.channels_last)
    got = block(z)
    want = tsm_nl.nonlocal_block(p, name, z, T, batch_stats=training)
    assert _rel(got, want) < REL
    assert _rel(got - z, want - z) < REL  # the block's own part


# -- the train step ----------------------------------------------------------

@pytest.fixture(scope="module")
def shards(tmp_path_factory) -> str:
    root = str(tmp_path_factory.mktemp("tsm"))
    return bm_data.shard_set(root, {"classes": 2, "clips_per_class": 2,
                                    "frames_per_clip": 6, "height": 40,
                                    "width": 52, "seed": 11})


def _train_cfg(cfg: dict, **kw) -> tr.TrainConfig:
    base = dict(num_classes=cfg["num_classes"], arch=ARCH, num_segments=T,
                batch_clips=2, lr=cfg["lr"], momentum=cfg["momentum"],
                weight_decay=cfg["weight_decay"], partial_bn=False,
                dropout=cfg["dropout"], compute_dtype="float32",
                scale_size=cfg["scale_size"], crop_size=cfg["crop_size"],
                seed=SEED)
    return tr.TrainConfig(**{**base, **kw})


def test_train_step_matches_reference(shards):
    """The first step of epoch 0 through ``train_epoch`` and
    ``make_train_step``: its loss, and each trained leaf's first gradient
    (SGD's momentum buffer less the weight decay), by leaf; the leaves
    whose reference gradient is exactly 0 in theory (φ's bias: softmax is
    blind to a shift of every key; g's and W's: a constant through to the
    batch-statistics BN, which removes it) hold round-off only and are
    left out."""
    cfg = _cfg(compute_dtype="float32")
    tcfg = _train_cfg(cfg)
    p0 = tsm_nl.make_weights(cfg, SEED, "cpu")
    state = tr.create_train_state(tcfg, "cpu", weights=p0)
    step = tr.make_train_step(tcfg, "cpu")
    seen = {}

    def first(state, frames, labels, key):
        state, m = step(state, frames, labels, key)
        if not seen:
            seen["loss"] = float(m["loss"])
            opt = state.optimizer
            seen["buf"] = {n: opt.state[p]["momentum_buffer"].clone()
                           for n, p in state.model.named_parameters()
                           if p in opt.state}
        return state, m

    tr.train_epoch(state, first, tcfg, EovcVideoDataset(shards), epoch=0)
    ref = tsm_train.first_steps(p0, cfg, {"batch_clips": 2},
                                ShardSet(shards), SEED, "cpu", n_steps=1)
    assert abs(seen["loss"] - ref["loss"][0]) <= REL * abs(ref["loss"][0])
    leaves, decay = tsm_train.trained(cfg, p0)
    assert set(leaves) == set(seen["buf"])
    norms = {n: float(ref["grad"][n].norm()) for n in leaves}
    med = float(np.median(list(norms.values())))
    quiet = [n for n in leaves if norms[n] < 1e-3 * med]
    assert sorted(quiet) == sorted(
        f"{t}.nl.{c}.bias" for t in cfg["nonlocal_blocks"]
        for c in ("phi", "g", "W"))
    for n in leaves:
        if n in quiet:
            continue
        g = seen["buf"][n] - (cfg["weight_decay"] * p0[n] if n in decay
                              else 0)
        assert _rel(g, ref["grad"][n]) < GRAD_REL, n


# -- extraction ----------------------------------------------------------------

@pytest.mark.parametrize("fold_bn", [True, False])
def test_feature_fn_matches_reference(fold_bn):
    """``make_feature_fn`` (every BN on its running statistics, folded or
    not) against the reference's clip features, with running statistics
    away from their init so that the fold does something."""
    cfg = _cfg()
    p = tsm_nl.make_weights(cfg, SEED, "cpu")
    g = torch.Generator().manual_seed(5)
    for k in [k for k in p if k.endswith("running_mean")]:
        p[k] = 0.1 * torch.randn(p[k].shape, generator=g)
        b = k[:-len("running_mean")]
        p[b + "running_var"] = 0.5 + torch.rand(p[k].shape, generator=g)
    frames = torch.randint(0, 256, (2, T, 40, 52, 3), dtype=torch.uint8,
                           generator=g)
    ecfg = ExtractConfig(num_segments=T, arch=ARCH, batch_clips=2,
                         scale_size=40, crop_size=32,
                         compute_dtype="float32", fold_bn=fold_bn)
    got = make_feature_fn(p, ecfg, "cpu")(frames)
    want = tsm_nl.features(p, cfg, frames, k=T, scale=40, crop=32)
    for a, b in zip(got, want):
        assert _rel(a, b) < REL


# -- refusals ------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{"quant": "int8"}, {"pallas_pool": True},
                                {"fused_stages": (1,)},
                                {"fused_stages": (1, 2, 3, 4)}])
def test_extract_refusals(kw):
    with pytest.raises(ValueError, match=ARCH):
        ExtractConfig(arch=ARCH, num_segments=T, **kw)


@pytest.mark.parametrize("kw", [{"fused_stage1": "on"},
                                {"fused_stage2": "on"}])
def test_train_refuses_fused_stages(kw):
    with pytest.raises(ValueError, match="kernels 8 and 9"):
        tr.resolve_fused(_train_cfg(_cfg(), **kw), "cpu")


def test_fused_stages_auto_resolve_off():
    cfg = _train_cfg(_cfg(), partial_bn=True)
    assert tr.resolve_fused(cfg, "cpu") == (False, False)
    assert ExtractConfig(arch=ARCH, num_segments=T).fused_stages == "auto"
    from eov_tpu_torch.models.folded_infer import resolve_fused_stages
    assert resolve_fused_stages("auto", arch=ARCH) == ()


def test_k_other_than_t_refused():
    cfg = _cfg()
    p = tsm_nl.make_weights(cfg, SEED, "cpu")
    fn = make_feature_fn(p, ExtractConfig(
        num_segments=T, arch=ARCH, scale_size=40, crop_size=32,
        compute_dtype="float32"), "cpu")
    with pytest.raises(ValueError, match="K=3"):
        fn(torch.zeros(1, 3, 40, 52, 3, dtype=torch.uint8))
    tcfg = _train_cfg(cfg)
    state = tr.create_train_state(tcfg, "cpu", weights=p)
    step = tr.make_train_step(tcfg, "cpu")
    with pytest.raises(ValueError, match="K=2"):
        step(state, torch.zeros(2, 2, 40, 52, 3, dtype=torch.uint8),
             torch.zeros(2, dtype=torch.int64), torch.zeros(2,
                                                            dtype=torch.int64))


def test_model_needs_t():
    with pytest.raises(ValueError, match="num_segments"):
        resnet.ResNet(ARCH)


# -- what resnet50 runs, and the published init --------------------------------

def test_resnet50_bottleneck_runs_no_shift(monkeypatch):
    """ResNet-50's blocks have no shift and no non-local block: its forward
    calls no shift and no non-local attention; the TSM arch's calls both,
    once a block and once a non-local block."""
    calls = {"shift": 0, "nonlocal": 0}

    def spy(kind, real):
        def fn(*a, **kw):
            calls[kind] += 1
            return real(*a, **kw)
        return fn
    monkeypatch.setattr(resnet, "temporal_shift",
                        spy("shift", resnet.temporal_shift))
    monkeypatch.setattr(resnet, "nonlocal_attention",
                        spy("nonlocal", resnet.nonlocal_attention))
    x = torch.randn(T, 32, 32, 3)
    counts = {}
    for arch in ("resnet50", ARCH):
        model = resnet.ResNet(arch, num_segments=T).eval()
        model.load_state_dict(resnet.random_state_dict(arch, seed=1))
        blocks = [m for m in model.modules()
                  if isinstance(m, resnet.Bottleneck)]
        before = dict(calls)
        with torch.no_grad():
            model(x)
        counts[arch] = (calls["shift"] - before["shift"],
                        calls["nonlocal"] - before["nonlocal"],
                        sum(b.nl is not None for b in blocks),
                        {b.shift_div for b in blocks})
    assert counts["resnet50"] == (0, 0, 0, {None})
    assert counts[ARCH] == (16, 5, 5, {8})


def test_published_init_is_identity():
    """``random_state_dict`` gives the non-local BN gamma 0: each block
    returns its input, bit for bit."""
    sd = resnet.random_state_dict(ARCH, seed=2)
    resnet.check_state_dict(sd, ARCH)
    model = resnet.ResNet(ARCH, num_segments=T).eval()
    model.load_state_dict(sd)
    z = torch.rand(2 * T, 512, 4, 4)
    with torch.no_grad():
        assert torch.equal(model.layer2[0].nl(z), z)


# -- the timed span --------------------------------------------------------------

class _Clock:
    """Events are host times; a pair reads their distance."""

    def record(self):
        import time

        return time.perf_counter()

    def done(self, ev) -> bool:
        return True

    def wait(self, ev) -> None:
        pass

    def read(self, pairs) -> list:
        return [o - c for c, o in pairs]


def test_timed_span_device_seconds():
    """A timed span's seconds land in its root's ``device_span_s``, from
    the root's thread and from another (autograd's backward)."""
    import threading
    import time

    trace.set_event_clock(lambda dev: _Clock())
    try:
        with trace.root("tsm.test", 0, torch.device("cpu")) as r:
            with trace.span("model.nonlocal", device=True, timed=True):
                time.sleep(0.01)

            def other():
                with trace.span("model.nonlocal", device=True, timed=True):
                    time.sleep(0.01)
            th = threading.Thread(target=other)
            th.start()
            th.join()
    finally:
        trace.set_event_clock(None)
    s = r.report["device_span_s"]["model.nonlocal"]
    assert 0.02 <= s < 0.2
    assert r.report["spans"]["model.nonlocal"]["n"] == 2


def test_config_matches_the_arch():
    """The benchmark's configuration states the port's shift and blocks."""
    cfg, temporal = _cfg(), resnet.get_temporal(ARCH)
    assert cfg["arch"] == ARCH and cfg["shift_div"] == temporal.shift_div
    assert cfg["nonlocal_blocks"] == list(temporal.nonlocal_blocks)
    assert list(resnet.get_arch(ARCH)[0]) == cfg["stage_sizes"]
