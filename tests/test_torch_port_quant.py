"""The port's int8 path against the JAX reference on the CPU: weight
quantization, calibration, the int8 walk, kernel 7's plain version, the
fused int8 forward, the int8 refusals and int8 store provenance.

Weights are made with the port's seeded generator and carried into the
reference with its own numpy porter; inputs come from numpy with a seed.
The reference's kernel 7 runs in Pallas interpret mode, as its own tests
run it. Wherever the two int8 programs are compared, both are fed the
reference's activation maxima: an ulp of difference in a scale moves
``round()`` at a knife edge to the neighbouring int8 code.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eov_tpu.data.store import FeatureStore as JStore
from eov_tpu.extract import ExtractConfig as JExtractConfig
from eov_tpu.extract import make_feature_fn as j_make_feature_fn
from eov_tpu.models import quant_infer as jq
from eov_tpu.models.resnet import fold_batchnorm as j_fold
from eov_tpu.ops.pallas_bottleneck_int8 import \
    fused_bottleneck_stack_int8 as j_stack_int8
from eov_tpu.tools.port_torch import port_resnet_state_dict

from eov_tpu_torch import extract as ex
from eov_tpu_torch.data.store import FeatureStore
from eov_tpu_torch.models import get_arch
from eov_tpu_torch.models import quant_infer as tq
from eov_tpu_torch.models.resnet import (fold_batchnorm, from_jax_variables,
                                         random_state_dict)
from eov_tpu_torch.ops import bottleneck_int8
from eov_tpu_torch.utils import trace

ARCH = "resnet18"


def launches(kernel) -> float:
    """The wrapper's kernel launches so far (its ``launch.<name>`` count)."""
    return trace.counter(f"launch.{kernel.__name__}")


def _variables(arch, seed, width=64):
    """Seeded weights with non-trivial BN statistics, as a flax tree."""
    sd = {k: v.numpy() for k, v in random_state_dict(
        arch, seed=seed, width=width).items()}
    rng = np.random.default_rng(seed + 7)

    def jitter(path, a):
        name = path[-1].key
        if name in ("var", "scale"):
            return a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a

    stage_sizes, bottleneck = get_arch(arch)
    return jax.tree_util.tree_map_with_path(jitter, port_resnet_state_dict(
        sd, stage_sizes=stage_sizes, bottleneck=bottleneck))


@pytest.fixture(scope="module")
def model():
    """resnet18 at full width, its folds in both packages, 64x64 frames and
    the reference's calibration on them."""
    v = _variables(ARCH, 0)
    j_folded = j_fold(v)
    frames = (np.random.default_rng(1).standard_normal((2, 64, 64, 3))
              * 0.7).astype(np.float32)
    j_act = jq.calibrate_act_max(j_folded, jnp.asarray(frames), arch=ARCH)
    return {
        "variables": v, "j_folded": j_folded, "frames": frames,
        "j_act": j_act, "act": {k: float(a) for k, a in j_act.items()},
        "folded": fold_batchnorm(from_jax_variables(v), ARCH),
    }


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(
        b, axis=-1)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_fold_bitwise_equals_reference(arch):
    """Every folded conv weight and bias equals the reference's bit for bit
    (the int8 weight scales are taken from them)."""
    v = _variables(arch, 3, width=16)
    want = j_fold(v)["params"]
    got = fold_batchnorm(from_jax_variables(v), arch)
    bias_of = {"conv1": "bn1", "downsample_conv": "downsample_bn"}
    for site, (t, c) in tq.conv_sites(arch).items():
        mod, _, conv = site.partition("/")
        g = got[t] if c is None else got[t][c]
        w = want[mod] if not conv else want[mod][conv]
        bn = bias_of.get(conv or site, f"bn{conv[-1:]}")
        b = want[bn] if not conv else want[mod][bn]
        np.testing.assert_array_equal(g["weight"].permute(2, 3, 1, 0).numpy(),
                                      np.asarray(w["kernel"]), err_msg=site)
        np.testing.assert_array_equal(g["bias"].numpy(), np.asarray(b["bias"]),
                                      err_msg=site)


def test_quantize_variables_matches_reference(model):
    """Same folded weights and act_max: kernel_q bitwise, w_scale and
    a_scale equal in f32, at every conv site."""
    want = jq.quantize_variables(model["j_folded"], model["j_act"])["params"]
    got = tq.quantize_variables(model["folded"], model["act"], ARCH)
    for site, (t, c) in tq.conv_sites(ARCH).items():
        g = got[t] if c is None else got[t][c]
        mod, _, conv = site.partition("/")
        w = want[mod] if not conv else want[mod][conv]
        np.testing.assert_array_equal(
            g["kernel_q"].permute(2, 3, 1, 0).numpy(),
            np.asarray(w["kernel_q"]), err_msg=site)
        np.testing.assert_array_equal(g["w_scale"].numpy(),
                                      np.asarray(w["w_scale"]), err_msg=site)
        assert g["a_scale"].numpy() == np.asarray(w["a_scale"]), site
    assert set(tq.conv_sites(ARCH)) == set(model["act"])


def test_calibrate_act_max_matches_reference(model):
    got = tq.calibrate_act_max(model["folded"],
                               torch.from_numpy(model["frames"]), arch=ARCH)
    assert set(got) == set(model["act"])
    for k, v in model["act"].items():
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("dtype,min_cos,tol", [
    ("float32", 0.99999, 1e-5), ("bfloat16", 0.999, 1e-2)])
def test_int8_walk_matches_reference(model, dtype, min_cos, tol):
    """The pure int8 walk (fused_stages=()), both fed the reference's
    act_max: per-clip cosine, and nearly every element within the tolerance
    of the feature scale (a knife-edge round() may move a few)."""
    jqv = jq.quantize_variables(model["j_folded"], model["j_act"])
    want = np.asarray(jq.quant_feature_apply(
        jqv, jnp.asarray(model["frames"]), arch=ARCH,
        dtype=getattr(jnp, dtype)), np.float32)
    qv = tq.quantize_variables(model["folded"], model["act"], ARCH)
    got = tq.quant_feature_apply(qv, torch.from_numpy(model["frames"]),
                                 arch=ARCH, dtype=getattr(torch, dtype),
                                 fused_stages=()).numpy()
    assert got.shape == want.shape == (2, 512)
    assert _cosine(got, want).min() >= min_cos
    scale = float(np.abs(want).max())
    assert np.isclose(got, want, rtol=tol, atol=tol * scale).mean() >= 0.999


def _mk_qblocks(rng, cin, cmid, cout, n_blocks):
    """Random int8 blocks in the reference kernel's layout (as
    tests/test_pallas_bottleneck.py builds them)."""
    def wq(shape):
        return rng.integers(-127, 128, shape, dtype=np.int8)

    def sc(c):
        return rng.uniform(1e-3, 2e-2, (1, c)).astype(np.float32)

    def inv():
        return rng.uniform(0.5, 4.0, (1, 1)).astype(np.float32)

    def bias(c):
        return (rng.standard_normal((1, c)) * 0.2).astype(np.float32)

    blocks = []
    for bi in range(n_blocks):
        ci = cin if bi == 0 else cout
        b = {"w1": wq((ci, cmid)), "s1": sc(cmid), "q1": inv(),
             "b1": bias(cmid), "w2": wq((9, cmid, cmid)), "s2": sc(cmid),
             "q2": inv(), "b2": bias(cmid), "w3": wq((cmid, cout)),
             "s3": sc(cout), "q3": inv(), "b3": bias(cout)}
        if bi == 0 and ci != cout:
            b.update({"wd": wq((ci, cout)), "sd": sc(cout), "qd": inv(),
                      "bd": bias(cout)})
        blocks.append(b)
    return blocks


def _port_blocks(blocks):
    """Reference kernel layout -> the port's (flat scales and biases)."""
    return [{k: (torch.from_numpy(v) if k[0] == "w"
                 else torch.from_numpy(v).reshape(-1)) for k, v in b.items()}
            for b in blocks]


@pytest.mark.parametrize("h,w", [(6, 10), (5, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_stack_plain_matches_pallas(h, w, dtype):
    """Kernel 7's plain version (the CPU path and the CUDA kernel's oracle)
    against the reference kernel in interpret mode: edge masks, requant
    chains, projection residual; the tolerance of the reference's own
    kernel-vs-walk test."""
    rng = np.random.default_rng(20)
    n, cin, cmid, cout = 2, 24, 16, 32
    blocks = _mk_qblocks(rng, cin, cmid, cout, 3)
    x = (rng.standard_normal((n, h * w, cin)) * 0.5).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(j_stack_int8(
        jnp.asarray(x).astype(jdt),
        [{k: jnp.asarray(v) for k, v in b.items()} for b in blocks],
        h=h, w=w, interpret=True), np.float32)
    before = launches(bottleneck_int8.fused_bottleneck_stack_int8)
    got = bottleneck_int8.fused_bottleneck_stack_int8(
        torch.from_numpy(x).to(tdt), _port_blocks(blocks), h=h, w=w)
    assert launches(bottleneck_int8.fused_bottleneck_stack_int8) == before
    assert got.dtype == tdt and tuple(got.shape) == (n, h * w, cout)
    got = got.float().numpy()
    rtol = 1e-5 if dtype == "float32" else 1e-2
    scale = float(np.abs(want).max())
    close = np.isclose(got, want, rtol=rtol, atol=rtol * scale)
    assert close.mean() > 0.999, (1 - close.mean(),
                                  np.abs(got - want).max())
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05 * scale)


def test_int8_stage1_fused_matches_reference():
    """The whole int8 forward with stage 1 fused (kernel 7's plain version
    here, the interpret-mode kernel in the reference) on resnet50 at
    64x64, 2 images, both fed the reference's act_max: the bar of the
    reference's own fused-vs-walk test.

    Frames seed 23: in f32, XLA on the CPU contracts the reference's
    dequant and bias add (``acc * scale + b``) into one FMA, the port (and
    the card's kernel) round twice, as the program is written. The 1-ulp
    difference can carry a requant round() across a knife edge: with frames
    seeds 22 and 28 one clip drifts to cosine 0.9999; with 23-27 and 29
    both clips agree to 1e-6. In bf16 the cast between them rules the FMA
    out."""
    v = _variables("resnet50", 5)
    j_folded = j_fold(v)
    frames = (np.random.default_rng(23).standard_normal((2, 64, 64, 3))
              * 0.7).astype(np.float32)
    j_act = jq.calibrate_act_max(j_folded, jnp.asarray(frames),
                                 arch="resnet50")
    want = np.asarray(jq.quant_feature_apply(
        jq.quantize_variables(j_folded, j_act), jnp.asarray(frames),
        arch="resnet50", dtype=jnp.float32, fused_stages=(1,),
        interpret=True))
    qv = tq.quantize_variables(
        fold_batchnorm(from_jax_variables(v), "resnet50"),
        {k: float(a) for k, a in j_act.items()}, "resnet50")
    before = launches(bottleneck_int8.fused_bottleneck_stack_int8)
    net = tq.QuantResNet(qv, arch="resnet50", dtype=torch.float32,
                         fused_stages=(1,))
    got = net(torch.from_numpy(frames)).numpy()
    assert net._packs and launches(
        bottleneck_int8.fused_bottleneck_stack_int8) == before  # plain
    # version on the CPU: no launch
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * scale)
    assert _cosine(got, want).min() >= 0.999999
    walk = tq.quant_feature_apply(qv, torch.from_numpy(frames),
                                  arch="resnet50", dtype=torch.float32,
                                  fused_stages=()).numpy()
    np.testing.assert_array_equal(got, walk)  # same arithmetic, same bits


def _cfg(**kw):
    base = dict(num_segments=2, arch=ARCH, scale_size=48, crop_size=40,
                batch_clips=4, compute_dtype="float32", quant="int8",
                quant_calib_clips=2, deterministic=True)
    base.update(kw)
    return base


def test_feature_program_matches_reference(model):
    """u8 clips at the eval scale -> int8 clip features, with the
    reference's synthetic calibration handed to both programs."""
    clips = np.random.default_rng(3).integers(0, 256, (2, 2, 48, 56, 3),
                                              dtype=np.uint8)
    jcfg = JExtractConfig(**_cfg(fused_stages=()))
    from eov_tpu import extract as jex
    act = jex.quant_calibration(model["variables"], jcfg)
    want = np.asarray(j_make_feature_fn(model["variables"], jcfg,
                                        act_max=act)(jnp.asarray(clips)))
    weights = from_jax_variables(model["variables"])
    cfg = ex.ExtractConfig(**_cfg())
    got = ex.make_feature_fn(weights, cfg, "cpu", act_max=act)(
        torch.from_numpy(clips)).numpy()
    assert _cosine(got, want).min() >= 0.99999
    # The port's own calibration: same sites, close values.
    mine = ex.quant_calibration(weights, cfg, device="cpu")
    assert set(mine) == set(act)
    for k in act:
        assert mine[k] == pytest.approx(act[k], rel=1e-5), k


def test_quant_calibration_provenance(model):
    """Synthetic scales through a JSON round trip reproduce the internal
    calibration bitwise; dataset scales differ; wrong-arch scales are
    refused with the cause named."""
    from eov_tpu_torch.data.datasets import SyntheticVideoDataset

    weights = from_jax_variables(model["variables"])
    cfg = ex.ExtractConfig(**_cfg())
    clips = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 2, 48, 56, 3), dtype=np.uint8))
    act = json.loads(json.dumps(ex.quant_calibration(weights, cfg,
                                                     device="cpu")))
    a = ex.make_feature_fn(weights, cfg, "cpu")(clips)
    b = ex.make_feature_fn(weights, cfg, "cpu", act_max=act)(clips)
    assert torch.equal(a, b)
    ds = SyntheticVideoDataset(n_classes=3, clips_per_class=1, height=48,
                               width=56, seed=3)
    dcfg = dataclasses.replace(cfg, quant_calib="dataset")
    act_ds = ex.quant_calibration(weights, dcfg, ds, device="cpu")
    assert act_ds.keys() == act.keys()
    assert any(abs(act_ds[k] - act[k]) > 1e-9 for k in act)
    with pytest.raises(ValueError, match="needs the extraction dataset"):
        ex.quant_calibration(weights, dcfg, None, device="cpu")
    with pytest.raises(ValueError, match="different --arch"):
        ex.make_feature_fn(random_state_dict("resnet34", width=8),
                           dataclasses.replace(cfg, arch="resnet34"), "cpu",
                           act_max={"conv1": 1.0})


def test_quant_refusals(model):
    """The reference's config-time refusals, before any decode."""
    weights = random_state_dict("resnet50", width=8)
    with pytest.raises(ValueError, match="only implemented scheme"):
        ex.ExtractConfig(**_cfg(quant="int4"))
    with pytest.raises(ValueError, match=r"\(1,\) only"):
        ex.make_feature_fn(weights, ex.ExtractConfig(
            **_cfg(arch="resnet50", fused_stages=(1, 2))), "cpu")
    with pytest.raises(ValueError, match="bottleneck archs only"):
        ex.make_feature_fn(from_jax_variables(model["variables"]),
                           ex.ExtractConfig(**_cfg(fused_stages=(1,))),
                           "cpu")
    with pytest.raises(ValueError, match="s2d"):
        ex.ExtractConfig(**_cfg(stem_s2d=True))
    with pytest.raises(ValueError, match="FOLDED"):
        ex.make_feature_fn(model["folded"], ex.ExtractConfig(**_cfg()),
                           "cpu")
    assert tq.resolve_quant_fused_stages("auto", arch="resnet50") == (1,)
    assert tq.resolve_quant_fused_stages("auto", arch="resnet18") == ()


def test_int8_store_provenance_both_ways(tmp_path):
    """An int8 store written by either package loads in the other with the
    same recorded quant and calibration; appending another precision is
    refused by both."""
    act = {"conv1": 3.25, "layer1_0/conv1": 1.5}
    rng = np.random.default_rng(6)
    for writer, reader in ((FeatureStore, lambda r: JStore(
            r, process_index=0)), (JStore, FeatureStore)):
        root = str(tmp_path / writer.__module__.split(".")[0])
        s = writer(root, class_names=["a", "b"], quant="int8")
        s.set_quant_calib(act)
        for i in range(4):
            s.put(f"v{i}", rng.standard_normal(8).astype(np.float32), i % 2)
        s.flush()
        back = reader(root)
        assert back.recorded_quant() == ("int8", True)
        assert back.quant_calib() == act
        assert len(back.load_all()) == 4
        with pytest.raises(ValueError, match="quant"):
            reader(root).__class__(root, quant=None)
    assert FeatureStore(str(tmp_path / "eov_tpu_torch")).summary() == {
        **JStore(str(tmp_path / "eov_tpu_torch"), process_index=0).summary(),
        "store": str(tmp_path / "eov_tpu_torch")}
