"""eov_tpu_torch's CUDA kernels against their plain PyTorch versions, on a
GPU. Every test here is marked ``cuda`` and skips without one; the file
imports only torch, numpy and the port (no JAX), so on a GPU machine:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eov_tpu_torch.models import quant_infer as tq
from eov_tpu_torch.models.folded_infer import (folded_feature_apply,
                                               use_full_f32)
from eov_tpu_torch.models.resnet import fold_batchnorm, random_state_dict
from eov_tpu_torch.ops import bottleneck, crop_normalize, pool, similarity
from eov_tpu_torch.ops import bottleneck_int8 as bi
from eov_tpu_torch.ops import bottleneck_train as bt
from eov_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda


def launches(kernel) -> float:
    """The wrapper's kernel launches so far (its ``launch.<name>`` count)."""
    return trace.counter(f"launch.{kernel.__name__}")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    use_full_f32()
    return torch.device("cuda")


@pytest.mark.parametrize("h,w,crop", [(65, 70, 63), (256, 320, 224),
                                      (256, 341, 224), (256, 340, 224)])
def test_crop_normalize_bitwise(dev, h, w, crop):
    """Real frame widths: UCF101 stored at short side 256 is 256x341 (a
    1023-byte row), Kinetics 256x340; and an odd crop (scalar stores)."""
    f = torch.randint(0, 256, (6, h, w, 3), dtype=torch.uint8, device=dev)
    for dt, iv in ((torch.float32, torch.int32),
                   (torch.bfloat16, torch.int16)):
        got = crop_normalize.crop_normalize_cuda(f, crop=crop, dtype=dt)
        want = crop_normalize.crop_normalize_plain(f, crop=crop, dtype=dt)
        assert torch.equal(got.view(iv), want.view(iv))


@pytest.mark.parametrize("offset", [1, 7])
@pytest.mark.parametrize("h,w,crop", [(256, 341, 224), (9, 10, 8)])
def test_crop_normalize_unaligned_base(dev, offset, h, w, crop):
    """A contiguous view at an odd storage offset of a flat uint8 buffer:
    the kernel's 16-byte loads start below the base, and the frames end
    inside a chunk. A guard byte either side must not leak in (the plain
    version reads the view alone)."""
    n = 3
    flat = torch.randint(0, 256, (n * h * w * 3 + offset + 16,),
                         dtype=torch.uint8, device=dev)
    f = flat[offset:offset + n * h * w * 3].view(n, h, w, 3)
    assert f.is_contiguous() and f.data_ptr() % 16 != 0
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
    before = launches(similarity.episode_class_scores)
    got = similarity.episode_class_scores(q, s, m, metric=metric,
                                          fusion=fusion)
    assert launches(similarity.episode_class_scores) == before + 1
    want = similarity.episode_class_scores(q.cpu(), s.cpu(), m.cpu(),
                                           metric=metric, fusion=fusion)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def _features(dev, gen, *shape):
    return torch.randn(*shape, generator=gen, device=dev)


@pytest.mark.parametrize("e", [1, 67])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_episode_scores_grid_edges(dev, e, metric):
    """One episode (one cluster) and 67 (not a multiple of anything the
    kernel splits by), at the protocol's Q, N, M and D."""
    gen = torch.Generator(device=dev).manual_seed(e)
    q = _features(dev, gen, e, 5, 2048)
    s = _features(dev, gen, e, 5, 1, 2048)
    m = torch.ones(e, 5, 1, device=dev)
    got = similarity.episode_scores_cuda(q, s, m, metric=metric)
    want = similarity.episode_scores_plain(q, s, m, metric=metric)
    torch.testing.assert_close(got, want, rtol=0.0 if metric == "cosine"
                               else 1e-6, atol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_episode_scores_embodied_masked(dev, metric):
    """The embodied eval's support (1 real + 5 virtual members a class,
    some masked: three support tiles, classes across tile edges)."""
    n, members = 5, 6
    # More support rows than one tile of the kernel (kST = 10 in
    # csrc/episode_scores.cu), so the member max crosses tile edges.
    assert n * members > 10
    gen = torch.Generator(device=dev).manual_seed(5)
    q = _features(dev, gen, 64, 5, 2048)
    s = _features(dev, gen, 64, n, members, 2048)
    m = (torch.rand(64, n, members, generator=gen, device=dev) > 0.4).float()
    m[..., 0] = 1
    got = similarity.episode_scores_cuda(q, s, m, metric=metric)
    want = similarity.episode_scores_plain(q, s, m, metric=metric)
    torch.testing.assert_close(got, want, rtol=0.0 if metric == "cosine"
                               else 1e-6, atol=1e-5)


def test_episode_scores_deterministic(dev):
    """Fixed-order reductions: the same bits run to run."""
    gen = torch.Generator(device=dev).manual_seed(9)
    q = _features(dev, gen, 64, 5, 2048)
    for m_ in (1, 6):
        s = _features(dev, gen, 64, 5, m_, 2048)
        m = torch.ones(64, 5, m_, device=dev)
        for metric in ("cosine", "euclidean"):
            a = similarity.episode_scores_cuda(q, s, m, metric=metric)
            b = similarity.episode_scores_cuda(q, s, m, metric=metric)
            assert torch.equal(a, b)


def test_folded_forward_gpu_matches_cpu(dev):
    """The whole folded forward (cuDNN + the stack kernel) in f32 on the
    GPU against the same forward on the CPU."""
    folded = fold_batchnorm(random_state_dict("resnet50", seed=3, width=16),
                            "resnet50")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 96, 96, 3)).astype(np.float32))
    before = launches(bottleneck.fused_bottleneck_stack)
    got = folded_feature_apply(folded, x.to(dev), dtype=torch.float32)
    assert launches(bottleneck.fused_bottleneck_stack) == before + 3
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
    f0 = launches(bt.train_stack_forward)
    b0 = launches(bt.train_stack_backward)
    got = bt.train_stack_forward_cuda(x, blocks, h=h, w=w, dtype=dtype)
    want = bt.train_stack_forward_plain(x, blocks, h=h, w=w, dtype=dtype)
    assert _rel(got, want) < tol
    dx, dws = bt.train_stack_backward_cuda(x, blocks, dy, h=h, w=w,
                                           dtype=dtype)
    dx_p, dws_p = bt.train_stack_backward_plain(x, blocks, dy, h=h, w=w,
                                                dtype=dtype)
    assert launches(bt.train_stack_forward) == f0 + 3
    assert launches(bt.train_stack_backward) == b0 + 3
    pairs = [("dx", dx, dx_p)] + [(f"{i}.{k}", d[k], p[k]) for i, (d, p)
                                  in enumerate(zip(dws, dws_p)) for k in p]
    for name, g, p in pairs:
        assert g.shape == p.shape, name
        assert _rel(g, p) < tol, (name, _rel(g, p))
        cos = F.cosine_similarity(g.flatten(), p.flatten(), dim=0)
        assert float(cos) > (0.99999 if dtype == torch.float32 else 0.999)


# One block at each of the train path's block shapes (ResNet-50 stage 1's
# entry and tail blocks, the stage-2 tail; chip_smoke.TRAIN_SHAPES), bf16
# at 4 images, held to check_train_stack's bars: the forward rtol/atol
# 2e-2 and cosine >= 0.999, dx and every dW relative L2 <= 2e-2 and
# cosine >= 0.999 (whole-tensor bars: at full shape a ReLU mask of the
# backward can flip where a pre-activation lies within rounding of zero).
TRAIN_PATH_BLOCKS = [(56, 56, 64, 64, 256, True), (56, 56, 256, 64, 256, False),
                     (28, 28, 512, 128, 512, False)]


@pytest.mark.parametrize("h,w,cin,cmid,cout,proj", TRAIN_PATH_BLOCKS)
def test_train_block_full_shape(dev, h, w, cin, cmid, cout, proj):
    rng = np.random.default_rng(cin + cout)

    def mk(shape, loc=0.0, scale=1.0):
        return torch.from_numpy(rng.normal(loc, scale, shape).astype(
            np.float32)).to(dev)

    b = {"w1": mk((cin, cmid), scale=cin ** -0.5),
         "w2": mk((9, cmid, cmid), scale=(9 * cmid) ** -0.5),
         "w3": mk((cmid, cout), scale=cmid ** -0.5),
         "s1": mk(cmid, 1, 0.1), "b1": mk(cmid, 0, 0.1),
         "s2": mk(cmid, 1, 0.1), "b2": mk(cmid, 0, 0.1),
         "s3": mk(cout, 1, 0.1), "b3": mk(cout, 0, 0.1)}
    if proj:
        b.update(wd=mk((cin, cout), scale=cin ** -0.5), sd=mk(cout, 1, 0.1),
                 bd=mk(cout, 0, 0.1))
    x = torch.relu(mk((4, h * w, cin)))
    dy = mk((4, h * w, cout))
    got = bt.train_stack_forward_cuda(x, [b], h=h, w=w)
    want = bt.train_stack_forward_plain(x, [b], h=h, w=w)
    assert float(((got - want).abs() - 2e-2 * (1 + want.abs())).max()) <= 0
    assert float(F.cosine_similarity(got.flatten(), want.flatten(),
                                     dim=0)) >= 0.999
    dx, dws = bt.train_stack_backward_cuda(x, [b], dy, h=h, w=w)
    dx_p, dws_p = bt.train_stack_backward_plain(x, [b], dy, h=h, w=w)
    pairs = [("dx", dx, dx_p)] + [(k, dws[0][k], dws_p[0][k])
                                  for k in dws_p[0]]
    assert sorted(dws[0]) == sorted(dws_p[0])
    for name, g, p in pairs:
        g, p = g.flatten(), p.flatten()
        rel_l2 = float((g - p).norm() / p.norm())
        cos = float(F.cosine_similarity(g, p, dim=0))
        assert rel_l2 <= 2e-2 and cos >= 0.999, (name, rel_l2, cos)


def test_train_forward_saves_y1_y2(dev):
    """A bf16 forward launch with saves writes y1 and y2 equal to the
    plain _block_forward's. x is a multiple of 1/4 in [0, 2], the weights
    multiples of 1/8 in [-1/4, 1/4], the scales multiples of 1/8 in
    [1/2, 3/2] and the shifts multiples of 1/16: then every f32 sum of both
    versions is exact (at most 20 significant bits), so the kernel's
    summation order cannot move a rounding to bf16."""
    rng = np.random.default_rng(21)
    h, w, cin, cmid, cout, n = 6, 7, 16, 8, 32, 2

    def grid(shape, step, lo, hi):
        return torch.from_numpy((rng.integers(lo, hi + 1, shape) * step)
                                .astype(np.float32)).to(dev)

    b = {"w1": grid((cin, cmid), 1 / 8, -2, 2),
         "w2": grid((9, cmid, cmid), 1 / 8, -2, 2),
         "w3": grid((cmid, cout), 1 / 8, -2, 2),
         "wd": grid((cin, cout), 1 / 8, -2, 2)}
    for k, c in (("1", cmid), ("2", cmid), ("3", cout), ("d", cout)):
        b["s" + k] = grid(c, 1 / 8, 4, 12)
        b["b" + k] = grid(c, 1 / 16, -4, 4)
    x = grid((n, h * w, cin), 1 / 4, 0, 8)
    pb = bt._prep_cuda(x, [b], torch.bfloat16)[0]
    out = torch.empty(n, h * w, cout, device=dev)
    y1, y2 = (torch.empty(n, h * w, cmid, dtype=torch.bfloat16, device=dev)
              for _ in range(2))
    bt._fwd_block_cuda(bt._lib(), x, pb, out, y1, y2, h, w, True,
                       bt._cuda.stream_ptr(dev))
    out_p, y1_p, y2_p = bt._block_forward(x, b, h, w, torch.bfloat16)
    assert y1_p.abs().max() > 0 and y2_p.abs().max() > 0
    assert torch.equal(y1, y1_p)
    assert torch.equal(y2, y2_p)
    assert torch.equal(out, out_p)


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

    f0 = launches(bt.train_stack_forward)
    got = grads(dev, lambda xb, bl: bt.bottleneck_stack_train(
        xb, bl, h=5, w=6, dtype=torch.float32))
    assert launches(bt.train_stack_forward) == f0 + 2

    def plain(xb, bl):
        for b in bl:
            xb = bt._block_forward(xb, b, 5, 6, torch.float32)[0]
        return xb

    want = grads("cpu", plain)
    for g, p in zip(got, want):
        torch.testing.assert_close(g.cpu(), p, rtol=1e-4, atol=1e-4)


def _int8_blocks(rng, cin, cmid, cout, n_blocks, dev, proj=True):
    """Random int8 blocks in the kernel's layout (weights, a*w_scale,
    1/a, f32 biases)."""
    blocks = []
    for bi_ in range(n_blocks):
        ci = cin if bi_ == 0 else cout

        def wq(*shape):
            return torch.from_numpy(rng.integers(-127, 128, shape,
                                                 dtype=np.int8)).to(dev)

        def f32(lo, hi, *shape):
            return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
                np.float32)).to(dev)

        b = {}
        for tag, (i, o) in (("1", (ci, cmid)), ("2", (cmid, cmid)),
                            ("3", (cmid, cout)), ("d", (ci, cout))):
            if tag == "d" and not (bi_ == 0 and (proj or ci != cout)):
                continue
            b[f"w{tag}"] = wq(9, i, o) if tag == "2" else wq(i, o)
            b[f"s{tag}"] = f32(1e-3, 2e-2, o)
            b[f"q{tag}"] = f32(0.5, 4.0, 1)
            b[f"b{tag}"] = f32(-0.3, 0.3, o)
        blocks.append(b)
    return blocks


# (h, w, cin, cmid, cout, projected first block): h != w, a width that is
# not a divisor of the 128-pixel tile, Cmid 8 (one word short of a chunk),
# and ResNet-50's stage-1 channels.
INT8_SHAPES = [(6, 7, 16, 8, 32, True), (5, 9, 32, 16, 32, False),
               (3, 130 // 2, 24, 16, 40, True), (9, 5, 64, 64, 256, True)]


@pytest.mark.parametrize("h,w,cin,cmid,cout,proj", INT8_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_stack_bitwise(dev, h, w, cin, cmid, cout, proj, dtype):
    """Kernel 7 gives its plain version's bits: both sum int8 products
    exactly in int32 and round at the same places."""
    rng = np.random.default_rng(h * w + cmid)
    blocks = _int8_blocks(rng, cin, cmid, cout, 3, dev, proj)
    x = torch.from_numpy((rng.standard_normal((3, h * w, cin)) * 0.7).astype(
        np.float32)).to(dev, dtype)
    before = launches(bi.fused_bottleneck_stack_int8)
    got = bi.fused_bottleneck_stack_int8(x, blocks, h=h, w=w)
    assert launches(bi.fused_bottleneck_stack_int8) == before + 3
    want = bi.bottleneck_stack_int8_plain(x, blocks, h=h, w=w)
    assert got.dtype == dtype and torch.equal(got, want)
    assert float((want != 0).float().mean()) > 0.3  # not all clipped to 0


def test_int8_stack_deterministic(dev):
    rng = np.random.default_rng(13)
    blocks = _int8_blocks(rng, 64, 64, 256, 3, dev)
    x = torch.relu(torch.from_numpy(rng.standard_normal(
        (4, 14 * 14, 64)).astype(np.float32))).to(dev, torch.bfloat16)
    a = bi.bottleneck_stack_int8_cuda(x, blocks, h=14, w=14)
    b = bi.bottleneck_stack_int8_cuda(x, blocks, h=14, w=14)
    assert torch.equal(a, b)


def _int8_stage1(dev, seed=7):
    """ResNet-50 stage 1 quantized as the int8 path quantizes it (seeded
    folded convs, per-channel weight scales, per-site activation maxima),
    packed for the kernel on dev."""
    gen = torch.Generator().manual_seed(seed)
    amax = {"conv1": 4.0, "conv2": 3.0, "conv3": 3.0, "downsample": 4.0}
    blocks = []
    for i in range(3):
        ci = 64 if i == 0 else 256

        def conv(o, cin, k):
            return {"weight": torch.randn(o, cin, k, k, generator=gen)
                    / (cin * k * k) ** 0.5,
                    "bias": 0.1 * torch.randn(o, generator=gen)}

        fb = {"conv1": conv(64, ci, 1), "conv2": conv(64, 64, 3),
              "conv3": conv(256, 64, 1)}
        if i == 0:
            fb["downsample"] = conv(256, ci, 1)
        q = {k: tq.quantize_conv(v, amax[k]) for k, v in fb.items()}
        blocks.append({k: v.to(dev) for k, v in
                       bi.pack_bottleneck_params_int8(q).items()})
    return blocks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_stack_resnet50_stage1(dev, dtype):
    """Kernel 7 at ResNet-50 stage 1's full channels and map (8 images):
    the entry block's 16-row tiles end in a ragged one of 8 rows."""
    blocks = _int8_stage1(dev)
    assert 56 % bi.int8_tile_plan(56, 56, 64, 64, 256, 8)["tile_rows"]
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.relu(torch.randn(8, 56 * 56, 64, generator=gen,
                               device=dev)).to(dtype)
    before = launches(bi.fused_bottleneck_stack_int8)
    got = bi.fused_bottleneck_stack_int8(x, blocks, h=56, w=56)
    assert launches(bi.fused_bottleneck_stack_int8) == before + 3
    want = bi.bottleneck_stack_int8_plain(x, blocks, h=56, w=56)
    assert got.dtype == dtype and torch.equal(got, want)
    assert float((want != 0).float().mean()) > 0.3


# (h, w, cin, cmid, cout, n): ragged last row tiles (entry block 13 = 8 +
# 5 rows with N passes of 256, and 30 = 20 + 10), and several images per
# block with a ragged last image group (7 = 5 + 2, then 2 + 2 + 2 + 1).
INT8_RAGGED = [(13, 56, 256, 64, 256, 2), (30, 44, 64, 64, 256, 2),
               (14, 14, 64, 64, 256, 7)]


@pytest.mark.parametrize("h,w,cin,cmid,cout,n", INT8_RAGGED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_stack_ragged_tiles(dev, h, w, cin, cmid, cout, n, dtype):
    rng = np.random.default_rng(h + w + n)
    blocks = _int8_blocks(rng, cin, cmid, cout, 2, dev, proj=cin != cout)
    plans = [bi.int8_tile_plan(h, w, c, cmid, cout, n) for c in (cin, cout)]
    assert any(h % p["tile_rows"] for p in plans) or \
        any(1 < p["images"] and n % p["images"] for p in plans)
    x = torch.from_numpy((rng.standard_normal((n, h * w, cin)) * 0.7).astype(
        np.float32)).to(dev, dtype)
    got = bi.bottleneck_stack_int8_cuda(x, blocks, h=h, w=w)
    want = bi.bottleneck_stack_int8_plain(x, blocks, h=h, w=w)
    assert torch.equal(got, want)


# Channels the 16-byte paths do not take: cin % 8 != 0 (scalar staging),
# cout % 8 != 0 (two channels a lane), odd cout (single stores).
INT8_ODD = [(5, 9, 20, 12, 36, 3), (4, 6, 21, 10, 33, 2)]


@pytest.mark.parametrize("h,w,cin,cmid,cout,n", INT8_ODD)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_stack_odd_channels(dev, h, w, cin, cmid, cout, n, dtype):
    rng = np.random.default_rng(cin * cout)
    blocks = _int8_blocks(rng, cin, cmid, cout, 2, dev, proj=True)
    x = torch.from_numpy((rng.standard_normal((n, h * w, cin)) * 0.7).astype(
        np.float32)).to(dev, dtype)
    got = bi.bottleneck_stack_int8_cuda(x, blocks, h=h, w=w)
    want = bi.bottleneck_stack_int8_plain(x, blocks, h=h, w=w)
    assert torch.equal(got, want)


def test_int8_smem_matches_plan(dev):
    """The kernel's shared-memory layout is the planner's at every block
    shape the int8 tests launch and at ResNet-50 stage 1."""
    lib = bi._lib()
    shapes = [(56, 56, 64, 64, 256, 256), (56, 56, 256, 64, 256, 256)]
    shapes += [(h, w, c, cmid, cout, 3) for h, w, cin, cmid, cout, _ in
               INT8_SHAPES for c in {cin, cout}]
    shapes += [(h, w, c, cmid, cout, n) for h, w, cin, cmid, cout, n in
               INT8_RAGGED + INT8_ODD for c in {cin, cout}]
    for h, w, c, cmid, cout, n in shapes:
        for proj in {c != cout, True}:
            p = bi.int8_tile_plan(h, w, c, cmid, cout, n, proj)
            assert lib.bottleneck_int8_smem_bytes(
                h, w, p["cinp"], p["cmidp"], p["tile_rows"], p["images"],
                p["wn1"], p["wn3"], int(proj)) == p["smem"]


def test_int_mm_padding(dev):
    """int_mm on the card at shapes cuBLASLt refuses as they are (M <= 16,
    K and N not multiples of 8) equals the exact int64 product."""
    g = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in ((5, 147, 13), (17, 16, 256), (40, 9, 64)):
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        want = (a.cpu().long() @ b.cpu().long()).int()
        assert torch.equal(bi.int_mm(a, b).cpu(), want)


def test_quant_forward_gpu_matches_cpu(dev):
    """The int8 forward (stage 1 through kernel 7, the rest int8 im2col
    matmuls) in f32 on the GPU against the same program on the CPU, with
    the same scales: only the global pool's summation order differs."""
    folded = fold_batchnorm(random_state_dict("resnet50", seed=3, width=16),
                            "resnet50")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 64, 64, 3)).astype(np.float32))
    qv = tq.calibrate_and_quantize(folded, x, arch="resnet50")
    before = launches(bi.fused_bottleneck_stack_int8)
    got = tq.quant_feature_apply(qv, x.to(dev), dtype=torch.float32,
                                 fused_stages=(1,))
    assert launches(bi.fused_bottleneck_stack_int8) == before + 3
    want = tq.quant_feature_apply(qv, x, dtype=torch.float32,
                                  fused_stages=(1,))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- kernels 4, 5 and 6

@pytest.mark.parametrize("shape", [(2, 10, 14, 24), (3, 12, 20, 64),
                                   (2, 8, 6, 5), (1, 112, 112, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxpool_kernel_equal(dev, shape, dtype):
    """Kernel 6 equals its plain version and F.max_pool2d (value equality:
    max is no arithmetic; C = 5 takes the scalar path)."""
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.relu(torch.randn(*shape, generator=g, device=dev)).to(dtype)
    before = launches(pool.maxpool_3x3_s2_nonneg)
    got = pool.maxpool_3x3_s2_nonneg(x)
    assert launches(pool.maxpool_3x3_s2_nonneg) == before + 1
    assert torch.equal(got, pool.maxpool_plain(x))
    lib = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    assert torch.equal(got, lib)


# ResNet-50's bottleneck stacks on kernel 2 at 224^2: stage 1 (entry block
# with projection) and the stride-1 tails of stages 2-4, as (h = w, cin,
# cmid, cout, blocks).
RESNET50_STACKS = [(56, 64, 64, 256, 3), (28, 512, 128, 512, 3),
                   (14, 1024, 256, 1024, 5), (7, 2048, 512, 2048, 2)]


def _lecun_blocks(rng, cin, cmid, cout, n_blocks, dev):
    """bf16 bottleneck blocks at the LeCun scale (1 / sqrt(fan in)); a
    projection on the first block when cin != cout."""
    def mk(shape, fan=None):
        a = rng.standard_normal(shape).astype(np.float32)
        a = torch.from_numpy(a / fan ** 0.5 if fan else a * 0.1).to(dev)
        return a.to(torch.bfloat16) if fan else a

    blocks = []
    for i in range(n_blocks):
        ci = cin if i == 0 else cout
        b = {"w1": mk((ci, cmid), ci), "b1": mk((cmid,)),
             "w2": mk((9, cmid, cmid), 9 * cmid), "b2": mk((cmid,)),
             "w3": mk((cmid, cout), cmid), "b3": mk((cout,))}
        if ci != cout:
            b["wd"], b["bd"] = mk((ci, cout), ci), mk((cout,))
        blocks.append(b)
    return blocks


def _check_bottleneck_per_block(x, blocks, h, w):
    """Kernel 2 in bf16: each block, fed the plain version's stream, within
    2 bf16 ulps of the magnitude the stream carries at the element's pixel
    (``bottleneck_stack_plain(stream_max=True)``); the whole stack at
    per-image cosine >= 0.9999; one launch per block."""
    xs = x
    for b in blocks:
        got = bottleneck.bottleneck_stack_cuda(xs, [b], h=h, w=w)
        want, top = bottleneck.bottleneck_stack_plain(xs, [b], h=h, w=w,
                                                      stream_max=True)
        ulps = float(((got.float() - want.float()).abs()
                      / bottleneck.bf16_ulp(top)).max())
        assert ulps <= 2, ulps
        xs = want
    before = launches(bottleneck.fused_bottleneck_stack)
    got = bottleneck.fused_bottleneck_stack(x, blocks, h=h, w=w)
    assert launches(bottleneck.fused_bottleneck_stack) == before + len(blocks)
    want = bottleneck.bottleneck_stack_plain(x, blocks, h=h, w=w)
    cos = float(F.cosine_similarity(got.float().flatten(1),
                                    want.float().flatten(1), dim=1).min())
    assert cos >= 0.9999, cos


@pytest.mark.parametrize("hw,cin,cmid,cout,nb", RESNET50_STACKS)
def test_bottleneck_stack_bf16_resnet50_stacks(dev, hw, cin, cmid, cout,
                                               nb):
    """The bf16 tensor-core kernel at ResNet-50's four stack shapes, 2
    images, LeCun-scale weights (``_check_bottleneck_per_block``)."""
    rng = np.random.default_rng(hw * cmid + nb)
    blocks = _lecun_blocks(rng, cin, cmid, cout, nb, dev)
    x = torch.relu(torch.from_numpy(rng.standard_normal(
        (2, hw * hw, cin)).astype(np.float32))).to(dev, torch.bfloat16)
    _check_bottleneck_per_block(x, blocks, hw, hw)


@pytest.mark.parametrize("h,w,cin,cmid,cout,n", [
    (14, 14, 40, 72, 136, 3), (5, 7, 24, 16, 40, 3), (6, 10, 24, 16, 40, 9),
    (9, 5, 136, 72, 136, 4), (56, 3, 64, 64, 256, 2),
    (6, 10, 20, 12, 36, 3)])
def test_bottleneck_stack_bf16_ragged(dev, h, w, cin, cmid, cout, n):
    """Channel counts padded to 64 (24, 16, 40, 72, 136), widths that are
    no multiple of 8, blocks of several whole images with n no multiple of
    them, a thin map of many tiles; channel counts no multiple of 8 (20,
    12, 36) take the scalar loads and stores."""
    rng = np.random.default_rng(h * w + cin + n)
    blocks = _lecun_blocks(rng, cin, cmid, cout, 2, dev)
    x = torch.relu(torch.from_numpy(rng.standard_normal(
        (n, h * w, cin)).astype(np.float32))).to(dev, torch.bfloat16)
    _check_bottleneck_per_block(x, blocks, h, w)


def test_bottleneck_bf16_smem_matches_plan(dev):
    """The kernel's shared-memory layout is the planner's, at every block
    shape of ResNet-50's stacks."""
    lib = bottleneck._lib()
    for hw, cin, cmid, cout, _ in RESNET50_STACKS:
        for ci in {cin, cout}:
            p = bottleneck.bottleneck_tile_plan(hw, hw, ci, cmid, cout, 256)
            assert lib.bottleneck_block_bf16_smem_bytes(
                hw, hw, ci, cmid, cout, p["cinp"], p["cmidp"], p["coutp"],
                p["tile_rows"], p["images"], p["wn1"], p["wn3"]) == p["smem"]


def _basic_blocks(rng, c, n_blocks, dev, dtype):
    def mk(shape, is_w=True):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             * (1 / (3 * c ** 0.5) if is_w else 0.1)).to(dev)
        return a.to(dtype) if is_w else a

    return [{"w1": mk((9, c, c)), "b1": mk((c,), False),
             "w2": mk((9, c, c)), "b2": mk((c,), False)}
            for _ in range(n_blocks)]


@pytest.mark.parametrize("h,w,c", [(5, 7, 24), (6, 10, 24), (5, 7, 512),
                                   (7, 7, 512), (14, 14, 256), (56, 3, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_basic_stack_kernel(dev, h, w, c, dtype):
    """Kernel 4 against its plain version elementwise; (7, 7, 512) in f32
    takes the smallest tile (3 rows), (56, 3) many tiles of a thin map."""
    rng = np.random.default_rng(h * w + c)
    blocks = _basic_blocks(rng, c, 2, dev, dtype)
    x = torch.relu(torch.from_numpy(rng.standard_normal(
        (3, h * w, c)).astype(np.float32))).to(dev, dtype)
    before = launches(bottleneck.fused_basic_stack)
    got = bottleneck.fused_basic_stack(x, blocks, h=h, w=w)
    assert launches(bottleneck.fused_basic_stack) == before + 2
    want = bottleneck.basic_stack_plain(x, blocks, h=h, w=w)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


# ResNet-34's fused basic stacks at 224^2: (h = w, C, blocks).
RESNET34_STACKS = [(56, 64, 3), (28, 128, 3), (14, 256, 5), (7, 512, 2)]


def _check_full_scale(x, blocks, h, w):
    """Each block, fed the plain version's stream, within 2 bf16 ulps of
    the magnitude the stream carries at the element's pixel
    (``basic_stack_plain(stream_max=True)``); the whole stack at per-image
    cosine >= 0.9999; one launch per block."""
    xs = x
    for b in blocks:
        got = bottleneck.basic_stack_cuda(xs, [b], h=h, w=w)
        want, top = bottleneck.basic_stack_plain(xs, [b], h=h, w=w,
                                                 stream_max=True)
        ulps = float(((got.float() - want.float()).abs()
                      / bottleneck.bf16_ulp(top)).max())
        assert ulps <= 2, ulps
        xs = want
    before = launches(bottleneck.fused_basic_stack)
    got = bottleneck.fused_basic_stack(x, blocks, h=h, w=w)
    assert launches(bottleneck.fused_basic_stack) == before + len(blocks)
    want = bottleneck.basic_stack_plain(x, blocks, h=h, w=w)
    cos = float(F.cosine_similarity(got.float().flatten(1),
                                    want.float().flatten(1), dim=1).min())
    assert cos >= 0.9999, cos


@pytest.mark.parametrize("hw,c,nb", RESNET34_STACKS)
def test_basic_stack_bf16_full_scale(dev, hw, c, nb):
    """The bf16 tensor-core kernel at ResNet-34's stack shapes, 4 images,
    LeCun-scale weights in both convs (``_check_full_scale``)."""
    rng = np.random.default_rng(hw * c + nb)
    blocks = _basic_blocks(rng, c, nb, dev, torch.bfloat16)
    x = torch.relu(torch.from_numpy(rng.standard_normal(
        (4, hw * hw, c)).astype(np.float32))).to(dev, torch.bfloat16)
    _check_full_scale(x, blocks, hw, hw)


@pytest.mark.parametrize("h,w,c,n", [(7, 7, 512, 5), (5, 7, 512, 3),
                                     (6, 10, 24, 9)])
def test_basic_stack_bf16_ragged_image_groups(dev, h, w, c, n):
    """A block spans several whole images; n is not a multiple of them, so
    the last block holds fewer."""
    plan = bottleneck.basic_tile_plan(h, w, c, n)
    assert plan["images"] > 1 and n % plan["images"]
    rng = np.random.default_rng(n * c)
    blocks = _basic_blocks(rng, c, 2, dev, torch.bfloat16)
    x = torch.relu(torch.from_numpy(rng.standard_normal(
        (n, h * w, c)).astype(np.float32))).to(dev, torch.bfloat16)
    _check_full_scale(x, blocks, h, w)


def test_basic_stack_bf16_smem_matches_plan(dev):
    """The kernel's shared-memory layout is the planner's, at every
    ResNet-18/34 stack shape."""
    lib = bottleneck._basic_lib()
    for hw, c, _ in RESNET34_STACKS:
        p = bottleneck.basic_tile_plan(hw, hw, c, 256)
        assert lib.basic_block_bf16_smem_bytes(
            hw, hw, c, p["cp"], p["tile_rows"], p["images"],
            p["wn"]) == p["smem"]


@pytest.mark.parametrize("h2,w2", [(10, 14), (12, 20), (112, 112)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_stack_kernel(dev, h2, w2, dtype):
    """Kernel 5 equals kernel 6 then kernel 2 bit for bit, and its plain
    version within kernel 2's bars; launches 1 of kernel 5, the tail
    blocks on kernel 2."""
    rng = np.random.default_rng(h2 + w2)
    cin = 24 if h2 < 100 else 64
    blocks = _blocks(rng, cin, 16, 40, 3, dev, dtype)
    n = 2
    x = torch.relu(torch.from_numpy(rng.standard_normal(
        (n, h2, w2, cin)).astype(np.float32))).to(dev, dtype)
    k5, k2 = (launches(bottleneck.fused_pool_bottleneck_stack),
              launches(bottleneck.fused_bottleneck_stack))
    got = bottleneck.fused_pool_bottleneck_stack(x, blocks)
    assert launches(bottleneck.fused_pool_bottleneck_stack) == k5 + 1
    assert launches(bottleneck.fused_bottleneck_stack) == k2 + 2
    h, w = h2 // 2, w2 // 2
    ref = bottleneck.bottleneck_stack_cuda(
        pool.maxpool_cuda(x).reshape(n, h * w, cin), blocks, h=h, w=w)
    assert torch.equal(got, ref)
    want = bottleneck.pool_bottleneck_stack_plain(x, blocks)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("cin,cout", [(20, 36), (24, 24)])
def test_pool_stack_bf16_scalar_and_identity(dev, cin, cout):
    """Kernel 5 in bf16 with channel counts no multiple of 8 (the scalar
    pool and stores) and with an identity first block (its residual is
    the pool), equal to kernel 6 then kernel 2."""
    rng = np.random.default_rng(cin + cout)
    blocks = _lecun_blocks(rng, cin, 16, cout, 2, dev)
    x = torch.relu(torch.from_numpy(rng.standard_normal(
        (2, 10, 14, cin)).astype(np.float32))).to(dev, torch.bfloat16)
    got = bottleneck.fused_pool_bottleneck_stack(x, blocks)
    ref = bottleneck.bottleneck_stack_cuda(
        pool.maxpool_cuda(x).reshape(2, 35, cin), blocks, h=5, w=7)
    assert torch.equal(got, ref)


def test_pool_stack_bf16_refuses_wide_input(dev):
    """Kernel 5 in bf16 pools one staged chunk of at most 64 channels (the
    stem's); a wider pre-pool map is refused before any launch."""
    rng = np.random.default_rng(7)
    blocks = _blocks(rng, 72, 16, 40, 1, dev, torch.bfloat16)
    x = torch.zeros(1, 10, 12, 72, device=dev, dtype=torch.bfloat16)
    before = launches(bottleneck.fused_pool_bottleneck_stack)
    with pytest.raises(ValueError, match="64 channels"):
        bottleneck.fused_pool_bottleneck_stack(x, blocks)
    assert launches(bottleneck.fused_pool_bottleneck_stack) == before


def test_basic_pool_forward_gpu_matches_cpu(dev):
    """resnet34 with every stage fused and the pool kernel (kernels 4 and
    6), and resnet50 with the pool-fused stage 1 (kernel 5), in f32 on the
    GPU against the same forwards on the CPU."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 96, 96, 3)).astype(np.float32))
    for arch, opts, launched in (
            ("resnet34", dict(fused_stages=(1, 2, 3, 4), pallas_pool=True),
             {bottleneck.fused_basic_stack: 3 + 3 + 5 + 2,
              pool.maxpool_3x3_s2_nonneg: 1}),
            ("resnet50", dict(fused_stages=(1,), pallas_pool="fused"),
             {bottleneck.fused_pool_bottleneck_stack: 1,
              bottleneck.fused_bottleneck_stack: 2})):
        folded = fold_batchnorm(random_state_dict(arch, seed=3, width=16),
                                arch)
        before = {k: launches(k) for k in launched}
        got = folded_feature_apply(folded, x.to(dev), arch=arch,
                                   dtype=torch.float32, **opts)
        assert {k: launches(k) - before[k] for k in launched} == launched
        want = folded_feature_apply(folded, x, arch=arch,
                                    dtype=torch.float32, **opts)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_pooled_extraction_from_raw_shard(dev, tmp_path):
    """extract_features over a RAW EOVC shard on the GPU: the pooled path
    (one get_batch per batch into page-locked ring buffers) gives the
    per-record path's features, and the ring's buffers are page-locked."""
    from eov_tpu_torch import extract
    from eov_tpu_torch.data.datasets import (EovcVideoDataset,
                                             SyntheticVideoDataset)
    from eov_tpu_torch.data.store import MemoryFeatureStore
    from eov_tpu_torch.tools.pack_eovc import pack

    src = SyntheticVideoDataset(n_classes=3, clips_per_class=3, height=48,
                                width=64, min_frames=8, max_frames=12)
    pack(src, str(tmp_path / "s.eovc"), storage_short_side=48)
    ds = EovcVideoDataset(str(tmp_path / "s.eovc"))
    cfg = extract.ExtractConfig(arch="resnet18", num_segments=3,
                                batch_clips=4, scale_size=48, crop_size=32)
    fn = extract.make_feature_fn(random_state_dict("resnet18", seed=0,
                                                   width=16), cfg, dev)
    class PerRecord:  # the same dataset without its pooled get_batch
        records, class_names = ds.records, ds.class_names
        get_frames = staticmethod(ds.get_frames)

    feats = {}
    for name, d in (("pooled", ds), ("record", PerRecord())):
        st = MemoryFeatureStore(class_names=ds.class_names)
        stats = extract.extract_features(d, None, st, cfg, feature_fn=fn,
                                         device=dev)
        assert stats["extracted"] == 9 and stats["failed"] == 0
        feats[name] = st.load_all()
    for vid, (f, _) in feats["pooled"].items():
        assert np.array_equal(f, feats["record"][vid][0]), vid
    ring = [b for stack in extract._HOST_BUFS.values() for b in stack
            if b.shape[2:4] == (48, 64)]
    assert ring and all(torch.from_numpy(b).is_pinned() for b in ring)


def test_matcher_switch_on_the_card(dev):
    """eval's matcher: 'auto' and 'pallas' launch kernel 3, 'xla' runs the
    plain version on the card; their per-episode accuracies agree."""
    from eov_tpu_torch.eval import EvalConfig, FeatureTable, evaluate

    g = torch.Generator().manual_seed(3)
    feats = (torch.randn(12, 6, 256, generator=g)
             + torch.randn(12, 1, 256, generator=g)).to(dev)
    table = FeatureTable(feats, torch.full((12,), 6, device=dev))
    runs = {}
    for m in ("auto", "pallas", "xla"):
        before = launches(similarity.episode_class_scores)
        runs[m] = evaluate(table, EvalConfig(n_episodes=128, matcher=m))
        launched = launches(similarity.episode_class_scores) - before
        assert (launched == 0) == (m == "xla"), (m, launched)
    assert np.array_equal(runs["auto"].per_episode, runs["pallas"].per_episode)
    agree = np.mean(runs["auto"].per_episode == runs["xla"].per_episode)
    assert agree >= 0.99


def test_trace_records_kernels(dev, tmp_path):
    """A --trace of GPU work holds kernel events, which profile_summary
    reads as device time."""
    from eov_tpu_torch.tools.profile_summary import summarize
    from eov_tpu_torch.utils.trace import trace

    x = torch.randn(512, 512, device=dev)
    with trace(str(tmp_path), dev):
        for _ in range(4):
            x = torch.tanh(x @ x)
    rows = summarize(str(tmp_path), top=3)
    assert rows[0]["device"] == "cuda" and rows[0]["device_busy_us"] > 0
    assert rows[1]["occurrences"] >= 4


def test_train_frames_page_locked_and_copied_whole(dev):
    """The train loop hands each step page-locked frames from its
    stacking thread. Every step here queues 20 ms of sleep before its
    asynchronous copy of them, so the copies lag the host by many steps
    while page-locked blocks are freed and handed out again; each device
    copy must still equal the frames the step was handed."""
    import types

    from eov_tpu_torch import train as tr
    from eov_tpu_torch.data.datasets import SyntheticVideoDataset

    ds = SyntheticVideoDataset(n_classes=2, clips_per_class=8, height=32,
                               width=40, seed=3)
    cfg = tr.TrainConfig(num_classes=2, arch="resnet18", num_segments=3,
                         batch_clips=2, seed=1)
    state = types.SimpleNamespace(model=torch.nn.Linear(2, 2).to(dev))
    host, copies = [], []

    def step(state, frames, labels, key):
        assert frames.is_pinned()
        host.append(frames.clone())
        torch.cuda._sleep(35_000_000)  # ~20 ms at the H100's clock
        copies.append(frames.to(dev, non_blocking=True))
        return state, {}

    _, out = tr.train_epoch(state, step, cfg, ds, epoch=0)
    torch.cuda.synchronize(dev)
    assert out["steps"] == len(copies) == 8
    bad = [s for s, (h, d) in enumerate(zip(host, copies))
           if not torch.equal(d.cpu(), h)]
    assert not bad, f"steps whose copy read a later batch: {bad}"
