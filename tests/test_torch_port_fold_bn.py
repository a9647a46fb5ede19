"""``ExtractConfig(fold_bn=False)`` against the JAX reference on the CPU:
the unfolded feature program (conv, then inference BatchNorm in f32 from
the running statistics) against the reference's ``make_feature_fn`` with
the same config, against the port's folded program, and the refusals
around the fold.

Weights are seeded port weights with BatchNorm statistics and affines drawn
from numpy seeds (so the BN is not the identity), handed to the reference
as flax variables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eov_tpu.extract import ExtractConfig as JConfig
from eov_tpu.extract import make_feature_fn as j_feature_fn
from torch_flax_variables import to_flax_variables

from eov_tpu_torch.extract import (ExtractConfig, UnfoldedResNet,
                                   make_feature_fn, quant_calibration)
from eov_tpu_torch.models.folded_infer import resolve_fused_stages
from eov_tpu_torch.models.resnet import random_state_dict


def _weights(arch, seed):
    """Seeded port weights with seeded BatchNorm statistics and affines
    (so the BN is not the identity), and the same as the reference's flax
    variables."""
    sd = random_state_dict(arch, seed=seed)
    rng = np.random.default_rng(seed)
    for k, v in sd.items():
        shape = tuple(v.shape)
        if k.endswith("running_mean"):
            sd[k] = torch.from_numpy(rng.normal(0, 0.1, shape))
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, shape))
        elif v.dim() == 1:  # BN weight and bias
            sd[k] = v + torch.from_numpy(rng.normal(0, 0.1, shape))
    sd = {k: v.float() for k, v in sd.items()}
    return sd, to_flax_variables(sd)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(5).integers(0, 256, (2, 3, 36, 44, 3),
                                             dtype=np.uint8)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b,
                                                                        axis=1)


def _cfgs(arch, dtype, **kw):
    common = dict(num_segments=3, arch=arch, scale_size=36, crop_size=32,
                  compute_dtype=dtype, **kw)
    return JConfig(fold_bn=False, **common), ExtractConfig(fold_bn=False,
                                                           **common)


@pytest.mark.parametrize("arch,s2d", [("resnet18", False), ("resnet18", True),
                                      ("resnet50", False)])
def test_unfolded_features_match_reference(frames, arch, s2d):
    """f32: per-clip cosine >= 0.99999 against the reference's unfolded
    program (its resize path; the port crops with kernel 1's plain version
    on frames stored at the eval scale, the same values)."""
    w, v = _weights(arch, seed=3)
    jc, tc = _cfgs(arch, "float32", stem_s2d=s2d)
    want = np.asarray(j_feature_fn(v, jc)(jnp.asarray(frames)))
    got = make_feature_fn(w, tc, "cpu")(
        torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (2, 512 if arch == "resnet18" else 2048)
    assert _cos(got, want).min() >= 0.99999


def test_unfolded_bf16_matches_reference(frames):
    """bf16 (each conv's output rounded to bf16 before the f32 BN affine,
    as flax's BatchNorm(dtype=float32) sees it): per-clip cosine >= 0.9999
    against the reference's bf16 program."""
    w, v = _weights("resnet18", seed=4)
    jc, tc = _cfgs("resnet18", "bfloat16")
    want = np.asarray(j_feature_fn(v, jc)(jnp.asarray(frames)))
    got = make_feature_fn(w, tc, "cpu")(
        torch.from_numpy(frames)).numpy()
    assert _cos(got, want).min() >= 0.9999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unfolded_matches_folded_program(frames, dtype):
    """The port's fold_bn=False and fold_bn=True programs agree (cosine >=
    0.99999 f32, >= 0.999 bf16); the folded one fuses stage 1 (kernel 2's
    plain version), the unfolded one fuses nothing."""
    w = _weights("resnet50", seed=6)[0]
    common = dict(num_segments=3, arch="resnet50", scale_size=36,
                  crop_size=32, compute_dtype=dtype)
    x = torch.from_numpy(frames)
    a = make_feature_fn(w, ExtractConfig(fold_bn=False, **common), "cpu")(x)
    b = make_feature_fn(w, ExtractConfig(**common), "cpu")(x)
    bar = 0.99999 if dtype == "float32" else 0.999
    assert _cos(a.numpy(), b.numpy()).min() >= bar
    assert resolve_fused_stages("auto", arch="resnet50",
                                folded=False) == ()
    assert resolve_fused_stages((1, 2), arch="resnet50", folded=False) == ()
    assert resolve_fused_stages("auto", arch="resnet50") == (1,)


def test_unfolded_net_is_the_inference_model():
    """The unfolded network holds the raw weights (BN statistics included)
    in inference mode, channels_last."""
    w = _weights("resnet18", seed=7)[0]
    net = UnfoldedResNet(w, arch="resnet18", dtype=torch.float32)
    assert not net.model.training
    sd = net.model.state_dict()
    for k in ("bn1.running_var", "layer1.0.bn1.running_mean",
              "conv1.weight"):
        assert torch.equal(sd[k], w[k])
    assert net.model.conv1.weight.is_contiguous(
        memory_format=torch.channels_last)


def test_fold_bn_refusals():
    """The reference's refusals (int8 and its calibration need the fold),
    and the port's: pallas_pool without the fold is refused, not
    ignored."""
    with pytest.raises(ValueError, match="fold_bn=True"):
        ExtractConfig(fold_bn=False, quant="int8")
    for pool in (True, "fused"):
        with pytest.raises(ValueError, match="fold_bn"):
            ExtractConfig(fold_bn=False, pallas_pool=pool,
                          fused_stages=(1,))
    w = _weights("resnet18", seed=8)[0]
    with pytest.raises(ValueError, match="fold_bn=True"):
        quant_calibration(w, ExtractConfig(arch="resnet18", fold_bn=False),
                          device="cpu")
    # Explicit fused stages resolve to () without the fold, as the
    # reference resolves them: the config builds.
    assert ExtractConfig(fold_bn=False, fused_stages=(1, 2)).fold_bn is False
