"""The port's weights, folded forward and feature program against the JAX
reference on the CPU, at ResNet-50 stage sizes with a narrow width.

Weights go through ``from_jax_variables`` (the carry-over every parity test
uses); frames are made with numpy from a seed. The reference's fused
stage-1 stack runs in Pallas interpret mode, the port's through its plain
version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eov_tpu.extract import ExtractConfig as JExtractConfig
from eov_tpu.extract import make_feature_fn as j_make_feature_fn
from eov_tpu.models.folded_infer import folded_feature_apply as j_folded
from eov_tpu.models.resnet import fold_batchnorm as j_fold
from eov_tpu.tools.port_torch import (export_resnet_state_dict,
                                      port_resnet_state_dict)

from eov_tpu_torch.extract import ExtractConfig, make_feature_fn
from eov_tpu_torch.models.folded_infer import (folded_feature_apply,
                                               resolve_fused_stages)
from eov_tpu_torch.models.resnet import (check_state_dict, fold_batchnorm,
                                         from_jax_variables,
                                         random_state_dict)


@pytest.fixture(scope="module")
def variables():
    """Narrow ResNet-50 with non-trivial BN statistics (so the fold
    matters), as numpy arrays."""
    # Built through the reference's own numpy porter (no flax init, which
    # costs a ResNet trace): torchvision-named random weights -> flax tree.
    sd = {k: v.numpy() for k, v in random_state_dict(
        "resnet50", seed=0, width=8).items()}
    v = port_resnet_state_dict(sd)
    rng = np.random.default_rng(7)

    def jitter(path, a):
        name = path[-1].key
        if name in ("var", "scale"):
            return a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(jitter, v)


def _cosine(a, b):
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(
        b, axis=-1)


def _frames(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_weight_carry_over_matches_reference_export(variables):
    """from_jax_variables == the reference's own torchvision export, and
    the port's random weights port back through the reference (strict)."""
    ours = from_jax_variables(variables)
    ref = export_resnet_state_dict(variables)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    check_state_dict(ours, "resnet50")
    rand = {k: v.numpy() for k, v in random_state_dict(
        "resnet50", seed=1, width=8).items()}
    back = port_resnet_state_dict(rand)
    assert back["params"]["layer1_0"]["conv1"]["kernel"].shape == (1, 1, 8, 8)


def test_state_dict_refuses_other_arch(variables):
    sd = from_jax_variables(variables)
    with pytest.raises(ValueError):
        check_state_dict(sd, "resnet18")  # unconsumed layers -> refused
    with pytest.raises(KeyError):
        check_state_dict(sd, "resnet101")


def test_fold_matches_reference(variables):
    ours = fold_batchnorm(from_jax_variables(variables), "resnet50")
    ref = j_fold(variables)["params"]
    np.testing.assert_array_equal(
        ours["layer1.0"]["conv2"]["weight"].permute(2, 3, 1, 0).numpy(),
        np.asarray(ref["layer1_0"]["conv2"]["kernel"]))
    np.testing.assert_array_equal(
        ours["layer2.0"]["downsample"]["bias"].numpy(),
        np.asarray(ref["layer2_0"]["downsample_bn"]["bias"]))


@pytest.mark.parametrize("jax_fused", [(1,), ()])
def test_folded_forward_f32(variables, jax_fused):
    x = _frames((2, 3, 64, 64, 3), 1)
    want = np.asarray(j_folded(j_fold(variables), jnp.asarray(x),
                               dtype=jnp.float32, fused_stages=jax_fused,
                               interpret=True))
    folded = fold_batchnorm(from_jax_variables(variables), "resnet50")
    got = folded_feature_apply(folded, torch.from_numpy(x),
                               dtype=torch.float32, fused_stages=(1,))
    assert tuple(got.shape) == want.shape == (2, 3, 256)
    got = got.numpy()
    assert _cosine(got, want).min() >= 0.99999
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_folded_forward_bf16(variables):
    x = _frames((2, 64, 64, 3), 2)
    want = np.asarray(j_folded(j_fold(variables), jnp.asarray(x),
                               dtype=jnp.bfloat16, fused_stages=(1,),
                               interpret=True))
    folded = fold_batchnorm(from_jax_variables(variables), "resnet50")
    got = folded_feature_apply(folded, torch.from_numpy(x),
                               dtype=torch.bfloat16).numpy()
    assert _cosine(got, want).min() >= 0.999


def test_fused_and_unfused_port_agree(variables):
    """Stage 1 (and a stage-2 tail) through the stack equals the per-conv
    path of the port itself."""
    x = torch.from_numpy(_frames((2, 64, 64, 3), 3))
    folded = fold_batchnorm(from_jax_variables(variables), "resnet50")
    a = folded_feature_apply(folded, x, dtype=torch.float32, fused_stages=())
    b = folded_feature_apply(folded, x, dtype=torch.float32,
                             fused_stages=(1, 2))
    torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


def test_resolve_fused_stages():
    """"auto" is (1,) on bottleneck archs and () on basic ones, as in the
    reference; explicit tuples are honored on both families (the basic
    stack is kernel 4)."""
    assert resolve_fused_stages("auto", arch="resnet50") == (1,)
    assert resolve_fused_stages("auto", arch="resnet18") == ()
    assert resolve_fused_stages((1,), arch="resnet34") == (1,)
    assert resolve_fused_stages((1, 2, 3, 4), arch="resnet18") == (1, 2, 3, 4)
    with pytest.raises(ValueError, match="out of range"):
        resolve_fused_stages((5,), arch="resnet34")


@pytest.mark.parametrize("h,w", [(72, 80), (80, 96)])
def test_feature_program_matches_reference(variables, h, w):
    """u8 clips -> clip features. 72x80 is stored at the eval scale
    (crop+normalize path); 80x96 takes the resize path."""
    clips = np.random.default_rng(h).integers(0, 256, (2, 3, h, w, 3),
                                              dtype=np.uint8)
    base = dict(num_segments=3, scale_size=72, crop_size=64,
                compute_dtype="float32")
    want = np.asarray(j_make_feature_fn(
        variables, JExtractConfig(fused_stages=(1,), **base))(
        jnp.asarray(clips)))
    fn = make_feature_fn(from_jax_variables(variables),
                         ExtractConfig(**base), device="cpu")
    got = fn(torch.from_numpy(clips)).numpy()
    assert got.shape == want.shape == (2, 256)
    assert _cosine(got, want).min() >= 0.99999
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_extract_config_refuses_unported_options():
    """pallas_pool and stem_s2d are ported: the config takes them and
    refuses only what the reference refuses (int8 with the s2d stem;
    'fused' on a basic arch) plus a pool flag with no fused stage to run
    it. int8 is the only quantization scheme (the reference's own
    refusal)."""
    for kw in ({"pallas_pool": "fused"}, {"pallas_pool": True},
               {"stem_s2d": True}):
        ExtractConfig(**kw)  # resnet50: "auto" fuses stage 1
    for kw in ({"quant": "int4"}, {"pallas_pool": "on"},
               {"quant": "int8", "stem_s2d": True},
               {"arch": "resnet18", "fused_stages": (1, 2, 3, 4),
                "pallas_pool": "fused"},
               {"arch": "resnet34", "pallas_pool": True}):
        with pytest.raises(ValueError):
            ExtractConfig(**kw)
