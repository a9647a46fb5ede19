"""eov_tpu_torch's CUDA kernels against their plain PyTorch versions, on a
GPU. Every test here is marked ``cuda`` and skips without one; the file
imports only torch, numpy and the port (no JAX), so on a GPU machine:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from eov_tpu_torch.models.folded_infer import (folded_feature_apply,
                                               use_full_f32)
from eov_tpu_torch.models.resnet import fold_batchnorm, random_state_dict
from eov_tpu_torch.ops import bottleneck, crop_normalize, similarity

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    use_full_f32()
    return torch.device("cuda")


@pytest.mark.parametrize("h,w,crop", [(65, 70, 63), (256, 320, 224)])
def test_crop_normalize_bitwise(dev, h, w, crop):
    f = torch.randint(0, 256, (6, h, w, 3), dtype=torch.uint8, device=dev)
    for dt, iv in ((torch.float32, torch.int32),
                   (torch.bfloat16, torch.int16)):
        got = crop_normalize.crop_normalize_cuda(f, crop=crop, dtype=dt)
        want = crop_normalize.crop_normalize_plain(f, crop=crop, dtype=dt)
        assert torch.equal(got.view(iv), want.view(iv))


def _blocks(rng, cin, cmid, cout, n_blocks, dev, dtype):
    blocks = []
    for bi in range(n_blocks):
        ci = cin if bi == 0 else cout

        def mk(shape, is_w=True):
            a = torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32) * 0.1).to(dev)
            return a.to(dtype) if is_w else a

        b = {"w1": mk((ci, cmid)), "b1": mk((cmid,), False),
             "w2": mk((9, cmid, cmid)), "b2": mk((cmid,), False),
             "w3": mk((cmid, cout)), "b3": mk((cout,), False)}
        if bi == 0 and ci != cout:
            b["wd"] = mk((ci, cout))
            b["bd"] = mk((cout,), False)
        blocks.append(b)
    return blocks


@pytest.mark.parametrize("h,w", [(6, 10), (5, 7), (56, 56), (3, 130 // 2)])
def test_bottleneck_stack_f32(dev, h, w):
    rng = np.random.default_rng(h * w)
    blocks = _blocks(rng, 24, 16, 32, 3, dev, torch.float32)
    x = torch.from_numpy(rng.standard_normal((2, h * w, 24)).astype(
        np.float32)).to(dev)
    got = bottleneck.bottleneck_stack_cuda(x, blocks, h=h, w=w)
    want = bottleneck.bottleneck_stack_plain(x, blocks, h=h, w=w)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_bottleneck_stack_bf16_ragged_channels(dev):
    """Channel counts that are not multiples of the 64-wide tiles."""
    rng = np.random.default_rng(5)
    blocks = _blocks(rng, 40, 72, 136, 2, dev, torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((3, 14 * 14, 40)).astype(
        np.float32)).to(dev, torch.bfloat16)
    got = bottleneck.bottleneck_stack_cuda(x, blocks, h=14, w=14)
    want = bottleneck.bottleneck_stack_plain(x, blocks, h=14, w=14)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("fusion", ["max", "mean"])
def test_episode_scores(dev, metric, fusion):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((4, 10, 96)).astype(
        np.float32)).to(dev)
    s = torch.from_numpy(rng.standard_normal((4, 5, 3, 96)).astype(
        np.float32)).to(dev)
    m = torch.from_numpy((rng.random((4, 5, 3)) > 0.3).astype(
        np.float32)).to(dev)
    m[..., 0] = 1
    before = similarity.episode_class_scores.launches
    got = similarity.episode_class_scores(q, s, m, metric=metric,
                                          fusion=fusion)
    assert similarity.episode_class_scores.launches == before + 1
    want = similarity.episode_class_scores(q.cpu(), s.cpu(), m.cpu(),
                                           metric=metric, fusion=fusion)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_folded_forward_gpu_matches_cpu(dev):
    """The whole folded forward (cuDNN + the stack kernel) in f32 on the
    GPU against the same forward on the CPU."""
    folded = fold_batchnorm(random_state_dict("resnet50", seed=3, width=16),
                            "resnet50")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 96, 96, 3)).astype(np.float32))
    before = bottleneck.fused_bottleneck_stack.launches
    got = folded_feature_apply(folded, x.to(dev), dtype=torch.float32)
    assert bottleneck.fused_bottleneck_stack.launches == before + 3
    want = folded_feature_apply(folded, x, dtype=torch.float32)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
