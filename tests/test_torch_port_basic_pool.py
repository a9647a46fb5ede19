"""The port's basic-block stack (kernel 4), stem max-pool (kernel 6),
pool-fused bottleneck stack (kernel 5) and space-to-depth stem against the
JAX reference on the CPU.

The reference's Pallas kernels run in interpret mode, as its own
``tests/test_pallas_basic.py`` and ``tests/test_pallas_pool.py`` run them;
the port's ops take their plain versions for CPU tensors. Weights go
through ``from_jax_variables``; inputs are made with numpy from seeds. One
reference forward per configuration is shared across the assertions that
read it (module fixtures).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eov_tpu.extract import ExtractConfig as JExtractConfig
from eov_tpu.extract import make_feature_fn as j_make_feature_fn
from eov_tpu.models.folded_infer import folded_feature_apply as j_folded
from eov_tpu.models.resnet import fold_batchnorm as j_fold
from eov_tpu.models.resnet import space_to_depth_stem as j_s2d
from eov_tpu.ops.pallas_bottleneck import \
    fused_basic_stack as j_basic_stack
from eov_tpu.ops.pallas_bottleneck import \
    fused_pool_bottleneck_stack as j_pool_stack
from eov_tpu.ops.pallas_pool import maxpool_3x3_s2_nonneg as j_pool
from eov_tpu.tools.port_torch import port_resnet_state_dict

from eov_tpu_torch import cli
from eov_tpu_torch.extract import ExtractConfig, make_feature_fn
from eov_tpu_torch.models import get_arch
from eov_tpu_torch.models.folded_infer import folded_feature_apply
from eov_tpu_torch.models.resnet import (fold_batchnorm, from_jax_variables,
                                         random_state_dict,
                                         space_to_depth_stem)
from eov_tpu_torch.ops import bottleneck as bn
from eov_tpu_torch.ops import pool

ARCHS = ("resnet18", "resnet34", "resnet50")


def _variables(arch: str, seed: int):
    """Narrow (width 8) random weights as the reference's flax variables,
    with non-trivial BN statistics so the fold matters."""
    stage_sizes, bottleneck = get_arch(arch)
    sd = {k: v.numpy() for k, v in random_state_dict(
        arch, seed=seed, width=8).items()}
    v = port_resnet_state_dict(sd, stage_sizes=stage_sizes,
                               bottleneck=bottleneck)
    rng = np.random.default_rng(seed + 100)

    def jitter(path, a):
        name = path[-1].key
        if name in ("var", "scale"):
            return a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(jitter, v)


@pytest.fixture(scope="module")
def variables():
    return {arch: _variables(arch, i) for i, arch in enumerate(ARCHS)}


def _cosine(a, b):
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(
        b, axis=-1)


def _frames(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _nonneg(shape, seed):
    """Post-ReLU-like input with exact zeros (the pool's tie case)."""
    return np.maximum(_frames(shape, seed), 0.0)


# ------------------------------------------------------------- kernel 6

@pytest.mark.parametrize("shape", [(2, 24, 24, 8), (1, 8, 12, 8),
                                   (3, 10, 14, 24), (2, 16, 6, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_plain_equals_reference(shape, dtype):
    """W = 12, 14, 6 are not multiples of 8; C = 5 is odd."""
    x = _nonneg(shape, sum(shape))
    want = np.asarray(j_pool(jnp.asarray(x).astype(dtype), interpret=True)
                      .astype(jnp.float32))
    got = pool.maxpool_3x3_s2_nonneg(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_pool_refuses_odd_hw():
    for shape in ((1, 7, 8, 4), (1, 8, 9, 4)):
        with pytest.raises(ValueError, match="even H/W"):
            pool.maxpool_3x3_s2_nonneg(torch.zeros(shape))
    with pytest.raises(ValueError, match="even H/W"):
        bn.fused_pool_bottleneck_stack(torch.zeros(1, 8, 9, 4), [])


# ------------------------------------------------------------- kernel 4

def _basic_blocks(rng, c, n_blocks):
    return [{k: rng.standard_normal(s).astype(np.float32) * 0.1
             for k, s in (("w1", (9, c, c)), ("b1", (1, c)),
                          ("w2", (9, c, c)), ("b2", (1, c)))}
            for _ in range(n_blocks)]


@pytest.mark.parametrize("h,w", [(6, 10), (5, 7), (8, 8)])
def test_basic_stack_plain_equals_reference(h, w):
    rng = np.random.default_rng(h * w)
    n, c = 2, 24
    blocks = _basic_blocks(rng, c, 2)
    x = rng.standard_normal((n, h * w, c)).astype(np.float32)
    want = np.asarray(j_basic_stack(
        jnp.asarray(x), [{k: jnp.asarray(v) for k, v in b.items()}
                         for b in blocks], h=h, w=w, interpret=True))
    got = bn.fused_basic_stack(
        torch.from_numpy(x), [{k: torch.from_numpy(v) for k, v in b.items()}
                              for b in blocks], h=h, w=w)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_pack_basic_params_refusals():
    """No projection block; Cin must equal Cout; stray or missing keys
    fail loudly (the reference's refusals)."""
    conv = {"weight": torch.zeros(16, 16, 3, 3), "bias": torch.zeros(16)}
    with pytest.raises(ValueError, match="projection"):
        bn.pack_basic_params({"conv1": conv, "conv2": conv,
                              "downsample": conv})
    wide = {"weight": torch.zeros(32, 16, 3, 3), "bias": torch.zeros(32)}
    with pytest.raises(ValueError, match="Cin == Cout"):
        bn.pack_basic_params({"conv1": wide, "conv2": conv})
    packed = bn.pack_basic_params({"conv1": conv, "conv2": conv})
    assert {k: tuple(v.shape) for k, v in packed.items()} == {
        "w1": (9, 16, 16), "b1": (16,), "w2": (9, 16, 16), "b2": (16,)}
    x = torch.zeros(1, 35, 16)
    with pytest.raises(KeyError, match="non-basic"):
        bn.fused_basic_stack(x, [dict(packed, w3=packed["w1"])], h=5, w=7)
    with pytest.raises(KeyError, match="b2"):
        bn.fused_basic_stack(x, [{k: v for k, v in packed.items()
                                  if k != "b2"}], h=5, w=7)


# ------------------------------------------------------------- kernel 5

def test_pool_stack_plain_equals_reference():
    """Pool + bottleneck stack, a projection first block, f32."""
    rng = np.random.default_rng(2)
    n, h2, w2, cin, cmid, cout = 2, 16, 12, 8, 8, 32

    def blk(ci, proj):
        b = {"w1": (ci, cmid), "b1": (1, cmid), "w2": (9, cmid, cmid),
             "b2": (1, cmid), "w3": (cmid, cout), "b3": (1, cout)}
        if proj:
            b.update(wd=(ci, cout), bd=(1, cout))
        return {k: rng.standard_normal(s).astype(np.float32) * 0.3
                for k, s in b.items()}

    blocks = [blk(cin, True), blk(cout, False)]
    x = _nonneg((n, h2, w2, cin), 3)
    want = np.asarray(j_pool_stack(
        jnp.asarray(x), [{k: jnp.asarray(v) for k, v in b.items()}
                         for b in blocks], interpret=True))
    tb = [{k: torch.from_numpy(v).reshape(-1) if k[0] == "b"
           else torch.from_numpy(v) for k, v in b.items()} for b in blocks]
    got = bn.fused_pool_bottleneck_stack(torch.from_numpy(x), tb)
    assert got.shape == (n, (h2 // 2) * (w2 // 2), cout)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # ... and it is the port's pool followed by its stack, bit for bit.
    pooled = pool.maxpool_3x3_s2_nonneg(torch.from_numpy(x))
    again = bn.fused_bottleneck_stack(
        pooled.reshape(n, -1, cin), tb, h=h2 // 2, w=w2 // 2)
    assert torch.equal(got, again)


# ------------------------------------------------------ the s2d stem

def test_space_to_depth_stem_equals_reference(variables):
    v = variables["resnet50"]
    ours = space_to_depth_stem(from_jax_variables(v))["conv1.weight"]
    ref = np.asarray(j_s2d(v)["params"]["conv1"]["kernel"])  # HWIO
    assert tuple(ours.shape) == (8, 12, 4, 4)
    np.testing.assert_array_equal(ours.permute(2, 3, 1, 0).numpy(), ref)
    # Idempotent, as the reference's rewrite is.
    twice = space_to_depth_stem(space_to_depth_stem(from_jax_variables(v)))
    assert torch.equal(twice["conv1.weight"], ours)


# -------------------------------------------------- the folded forward

# (arch, folded_feature_apply options, dtype); one reference forward each.
FORWARDS = {
    "resnet18_fused_pool": ("resnet18", dict(fused_stages=(1, 2, 3, 4),
                                             pallas_pool=True), "float32"),
    "resnet34_fused_pool": ("resnet34", dict(fused_stages=(1, 2, 3, 4),
                                             pallas_pool=True), "float32"),
    "resnet50_pool_fused": ("resnet50", dict(fused_stages=(1,),
                                             pallas_pool="fused"),
                            "float32"),
    "resnet50_s2d_pool_fused": ("resnet50", dict(fused_stages=(1,),
                                                 pallas_pool="fused",
                                                 stem_s2d=True), "float32"),
    "resnet34_fused_pool_bf16": ("resnet34", dict(fused_stages=(1, 2, 3, 4),
                                                  pallas_pool=True),
                                 "bfloat16"),
}


@pytest.fixture(scope="module")
def forwards(variables):
    """{name: (port features, reference features)} at 48x48, 2 images."""
    x = _frames((2, 48, 48, 3), 11)
    out = {}
    for name, (arch, opts, dtype) in FORWARDS.items():
        v = variables[arch]
        jv, sd = j_fold(v), from_jax_variables(v)
        if opts.get("stem_s2d"):
            jv, sd = j_s2d(jv), space_to_depth_stem(sd)
        want = np.asarray(j_folded(jv, jnp.asarray(x), arch=arch,
                                   dtype=getattr(jnp, dtype),
                                   interpret=True, **opts))
        got = folded_feature_apply(
            fold_batchnorm(sd, arch), torch.from_numpy(x), arch=arch,
            dtype=getattr(torch, dtype), **opts).numpy()
        out[name] = (got, want)
    return out


@pytest.mark.parametrize("name", [k for k, v in FORWARDS.items()
                                  if v[2] == "float32"])
def test_folded_forward_f32_equals_reference(forwards, name):
    got, want = forwards[name]
    dim = 64 if FORWARDS[name][0] != "resnet50" else 256
    assert got.shape == want.shape == (2, dim)
    assert _cosine(got, want).min() >= 0.99999
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_folded_forward_bf16_equals_reference(forwards):
    got, want = forwards["resnet34_fused_pool_bf16"]
    assert _cosine(got, want).min() >= 0.999


def test_fused_pool_paths_equal_plain_port(variables):
    """On the port itself: kernel 4 stacks with the zero-pad pool equal the
    unfused cuDNN-path forward to rounding; the pool-fused stage 1 equals
    the plain-pool stage 1 bit for bit."""
    x = torch.from_numpy(_frames((2, 48, 48, 3), 12))
    f34 = fold_batchnorm(from_jax_variables(variables["resnet34"]),
                         "resnet34")
    a = folded_feature_apply(f34, x, arch="resnet34", dtype=torch.float32,
                             fused_stages=())
    b = folded_feature_apply(f34, x, arch="resnet34", dtype=torch.float32,
                             fused_stages=(1, 2, 3, 4), pallas_pool=True)
    torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    f50 = fold_batchnorm(from_jax_variables(variables["resnet50"]),
                         "resnet50")
    c = folded_feature_apply(f50, x, dtype=torch.float32, fused_stages=(1,))
    d = folded_feature_apply(f50, x, dtype=torch.float32, fused_stages=(1,),
                             pallas_pool="fused")
    assert torch.equal(c, d)


def test_folded_forward_refusals(variables):
    f18 = fold_batchnorm(from_jax_variables(variables["resnet18"]),
                         "resnet18")
    x = torch.zeros(1, 32, 32, 3)
    with pytest.raises(ValueError, match="bottleneck archs only"):
        folded_feature_apply(f18, x, arch="resnet18", fused_stages=(1,),
                             pallas_pool="fused")
    f50 = fold_batchnorm(from_jax_variables(variables["resnet50"]),
                         "resnet50")
    with pytest.raises(ValueError, match="requires stage 1"):
        folded_feature_apply(f50, x, fused_stages=(2,), pallas_pool="fused")
    with pytest.raises(ValueError, match="space_to_depth_stem"):
        folded_feature_apply(f50, x, stem_s2d=True)
    with pytest.raises(ValueError, match="pallas_pool"):
        folded_feature_apply(f50, x, pallas_pool="on")


# ---------------------------------------------------- the feature program

def test_feature_program_equals_reference(variables):
    """make_feature_fn of both packages, resnet34 with every stage fused
    and the pool kernel, u8 clips at the eval scale (crop path)."""
    clips = np.random.default_rng(5).integers(0, 256, (2, 3, 56, 72, 3),
                                              dtype=np.uint8)
    base = dict(arch="resnet34", num_segments=3, scale_size=56,
                crop_size=48, compute_dtype="float32",
                fused_stages=(1, 2, 3, 4), pallas_pool=True)
    v = variables["resnet34"]
    want = np.asarray(j_make_feature_fn(v, JExtractConfig(**base))(
        jnp.asarray(clips)))
    got = make_feature_fn(from_jax_variables(v), ExtractConfig(**base),
                          device="cpu")(torch.from_numpy(clips)).numpy()
    assert got.shape == want.shape == (2, 64)
    assert _cosine(got, want).min() >= 0.99999


@pytest.mark.parametrize("kw,match", [
    # the reference's config-time refusals
    (dict(arch="resnet50", fused_stages=(2,), pallas_pool="fused"),
     "requires stage 1"),
    (dict(arch="resnet18", fused_stages=(1, 2, 3, 4), pallas_pool="fused"),
     "bottleneck archs only"),
    (dict(arch="resnet50", quant="int8", stem_s2d=True), "stem_s2d=False"),
    # stricter than the reference, which logs and ignores the flag
    (dict(arch="resnet34", pallas_pool=True), "--fused-stages"),
    (dict(arch="resnet50", fused_stages=(), pallas_pool=True),
     "--fused-stages"),
    (dict(arch="resnet50", quant="int8", pallas_pool="fused"),
     "drop --pallas-pool"),
])
def test_config_time_refusals(kw, match):
    """Refused when the config is made, before any weights, dataset or
    device; the same config without the flag is accepted."""
    with pytest.raises(ValueError, match=match):
        ExtractConfig(**kw)
    ExtractConfig(**{k: v for k, v in kw.items()
                     if k not in ("pallas_pool", "stem_s2d")})


def test_cli_extract_pallas_pool_on(tmp_path, capsys):
    """extract --arch resnet18 --fused-stages 1,2,3,4 --pallas-pool on on
    the CPU; the store equals the cuDNN-path extraction to f32 rounding.
    Without --fused-stages the flag is refused before any work."""
    common = ["--device", "cpu", "--preset", "synthetic_smoke", "--arch",
              "resnet18", "--synthetic-classes", "3", "--synthetic-clips",
              "2", "--synthetic-height", "40", "--synthetic-width", "48",
              "--scale-size", "40", "--crop-size", "32"]
    stores = {}
    for tag, extra in (("fused", ["--fused-stages", "1,2,3,4",
                                  "--pallas-pool", "on"]),
                       ("plain", ["--fused-stages", "none",
                                  "--pallas-pool", "off"])):
        stores[tag] = str(tmp_path / tag)
        assert cli.main(["extract", *common, "--store", stores[tag],
                         *extra]) == 0
        last = capsys.readouterr().out.strip().splitlines()[-1]
        assert json.loads(last)["extracted"] == 6
    from eov_tpu_torch.data.store import FeatureStore

    a, b = (FeatureStore(stores[t]).load_all() for t in ("fused", "plain"))
    assert sorted(a) == sorted(b)
    for vid in a:
        np.testing.assert_allclose(a[vid][0], b[vid][0], rtol=2e-5,
                                   atol=2e-5)
    with pytest.raises(SystemExit, match="--fused-stages"):
        cli.main(["extract", *common, "--store", str(tmp_path / "x"),
                  "--pallas-pool", "on"])
    assert not (tmp_path / "x").exists()
