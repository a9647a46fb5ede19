"""eov_tpu_torch's CUDA kernels against their plain PyTorch versions, on a
GPU. Every test here is marked ``cuda`` and skips without one; the file
imports only torch, numpy and the port (no JAX), so on a GPU machine:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eov_tpu_torch.models.folded_infer import (folded_feature_apply,
                                               use_full_f32)
from eov_tpu_torch.models.resnet import fold_batchnorm, random_state_dict
from eov_tpu_torch.ops import bottleneck, crop_normalize, similarity
from eov_tpu_torch.ops import bottleneck_train as bt

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


def _train_blocks(rng, cin, cmid, cout, n_blocks, dev, proj=True):
    """f32 train-stack blocks (weights and frozen affines)."""
    blocks = []
    for bi in range(n_blocks):
        ci = cin if bi == 0 else cout

        def mk(shape, loc=0.0, scale=0.2):
            return torch.from_numpy(rng.normal(loc, scale, shape).astype(
                np.float32)).to(dev)

        b = {"w1": mk((ci, cmid)), "w2": mk((9, cmid, cmid), scale=0.1),
             "w3": mk((cmid, cout)),
             "s1": mk(cmid, 1, 0.1), "b1": mk(cmid, 0, 0.1),
             "s2": mk(cmid, 1, 0.1), "b2": mk(cmid, 0, 0.1),
             "s3": mk(cout, 1, 0.1), "b3": mk(cout, 0, 0.1)}
        if bi == 0 and (proj or ci != cout):
            b.update(wd=mk((ci, cout)), sd=mk(cout, 1, 0.1),
                     bd=mk(cout, 0, 0.1))
        blocks.append(b)
    return blocks


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-6))


# (h, w, cin, cmid, cout, projected first block): h != w catches an
# off-by-one in the mirrored taps of the transposed 3x3; Cmid 64 and 128
# are the two stages of the main path.
TRAIN_SHAPES = [(6, 7, 16, 8, 32, True), (9, 5, 64, 64, 256, True),
                (7, 10, 128, 128, 128, False), (3, 130 // 2, 24, 16, 40, True)]


@pytest.mark.parametrize("h,w,cin,cmid,cout,proj", TRAIN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_stack_kernels(dev, h, w, cin, cmid, cout, proj, dtype):
    """Kernel 8 (forward) and kernel 9 (dx and every dW) against the plain
    versions: f32 to 1e-4 relative, bf16 to 2e-2 relative with cosine."""
    rng = np.random.default_rng(h * w + cmid)
    blocks = _train_blocks(rng, cin, cmid, cout, 3, dev, proj)
    x = torch.relu(torch.from_numpy(rng.normal(
        0, 1, (3, h * w, cin)).astype(np.float32)).to(dev))
    dy = torch.from_numpy(rng.normal(0, 1, (3, h * w, cout)).astype(
        np.float32)).to(dev)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    f0, b0 = bt.train_stack_forward.launches, bt.train_stack_backward.launches
    got = bt.train_stack_forward_cuda(x, blocks, h=h, w=w, dtype=dtype)
    want = bt.train_stack_forward_plain(x, blocks, h=h, w=w, dtype=dtype)
    assert _rel(got, want) < tol
    dx, dws = bt.train_stack_backward_cuda(x, blocks, dy, h=h, w=w,
                                           dtype=dtype)
    dx_p, dws_p = bt.train_stack_backward_plain(x, blocks, dy, h=h, w=w,
                                                dtype=dtype)
    assert bt.train_stack_forward.launches == f0 + 3
    assert bt.train_stack_backward.launches == b0 + 3
    pairs = [("dx", dx, dx_p)] + [(f"{i}.{k}", d[k], p[k]) for i, (d, p)
                                  in enumerate(zip(dws, dws_p)) for k in p]
    for name, g, p in pairs:
        assert g.shape == p.shape, name
        assert _rel(g, p) < tol, (name, _rel(g, p))
        cos = F.cosine_similarity(g.flatten(), p.flatten(), dim=0)
        assert float(cos) > (0.99999 if dtype == torch.float32 else 0.999)


def test_train_stack_dw_deterministic(dev):
    """Two backward runs on the same inputs give bitwise-equal dW and dx
    (per-image partials summed in a fixed order, no float atomics)."""
    rng = np.random.default_rng(11)
    blocks = _train_blocks(rng, 64, 64, 256, 3, dev)
    x = torch.from_numpy(rng.normal(0, 1, (8, 14 * 14, 64)).astype(
        np.float32)).to(dev)
    dy = torch.from_numpy(rng.normal(0, 1, (8, 14 * 14, 256)).astype(
        np.float32)).to(dev)
    runs = [bt.train_stack_backward_cuda(x, blocks, dy, h=14, w=14,
                                         dtype=torch.bfloat16)
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_train_stack_autograd_on_gpu(dev):
    """The autograd Function on CUDA tensors launches both kernels and
    agrees with torch.autograd through the plain forward on the CPU."""
    rng = np.random.default_rng(12)
    blocks = _train_blocks(rng, 16, 8, 32, 2, dev)
    x = torch.from_numpy(rng.normal(0, 1, (2, 5 * 6, 16)).astype(
        np.float32))

    def grads(device, fn):
        xb = x.to(device).requires_grad_()
        bl = [{k: v.detach().to(device).requires_grad_(k[0] == "w")
               for k, v in b.items()} for b in blocks]
        fn(xb, bl).sin().sum().backward()
        return [xb.grad] + [b[k].grad for b in bl for k in b if k[0] == "w"]

    f0 = bt.train_stack_forward.launches
    got = grads(dev, lambda xb, bl: bt.bottleneck_stack_train(
        xb, bl, h=5, w=6, dtype=torch.float32))
    assert bt.train_stack_forward.launches == f0 + 2

    def plain(xb, bl):
        for b in bl:
            xb = bt._block_forward(xb, b, 5, 6, torch.float32)[0]
        return xb

    want = grads("cpu", plain)
    for g, p in zip(got, want):
        torch.testing.assert_close(g.cpu(), p, rtol=1e-4, atol=1e-4)
