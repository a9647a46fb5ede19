"""The port's three kernel modules against the JAX reference, on the CPU.

Each op of eov_tpu_torch takes its plain PyTorch version for a CPU tensor;
here that version is held against the Pallas kernel it replaces, run as
the reference's own tests run it (interpret=True), on inputs made with
numpy from a seed. The CUDA kernels themselves are held against these
plain versions in test_torch_port_cuda.py (on a GPU) and chip_smoke.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from eov_tpu.ops import similarity as jsim
from eov_tpu.ops.pallas_bottleneck import fused_bottleneck_stack as jstack
from eov_tpu.ops.pallas_preprocess import crop_normalize as jcrop
from eov_tpu.ops.pallas_similarity import episode_class_scores as jscores

from eov_tpu_torch.ops import bottleneck, crop_normalize, similarity


# ------------------------------------------------------------ crop_normalize

@pytest.mark.parametrize("h,w,crop", [(72, 77, 64), (65, 70, 63),
                                      (64, 80, 64), (40, 57, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crop_normalize_bitwise_vs_pallas(h, w, crop, dtype):
    """Odd sizes, W*3 not a multiple of 16: every bit equal."""
    frames = np.random.default_rng(h * w).integers(
        0, 256, (2, 3, h, w, 3), dtype=np.uint8)
    want = np.asarray(jcrop(jnp.asarray(frames), crop=crop,
                            dtype=getattr(jnp, dtype), interpret=True))
    got = crop_normalize.crop_normalize(
        torch.from_numpy(frames), crop=crop, dtype=getattr(torch, dtype))
    assert tuple(got.shape) == want.shape
    got = got.float().numpy()
    want = want.astype(np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_crop_normalize_refuses_bad_input():
    with pytest.raises(ValueError):
        crop_normalize.crop_normalize(torch.zeros(1, 32, 32, 3,
                                                  dtype=torch.uint8), crop=64)
    with pytest.raises(TypeError):
        crop_normalize.crop_normalize(torch.zeros(1, 64, 64, 3), crop=32)


# ---------------------------------------------------------- bottleneck stack

def _mk_blocks(rng, cin, cmid, cout, n_blocks):
    blocks = []
    for bi in range(n_blocks):
        ci = cin if bi == 0 else cout

        def mk(shape):
            return rng.standard_normal(shape).astype(np.float32) * 0.1

        b = {"w1": mk((ci, cmid)), "b1": mk((1, cmid)),
             "w2": mk((9, cmid, cmid)), "b2": mk((1, cmid)),
             "w3": mk((cmid, cout)), "b3": mk((1, cout))}
        if bi == 0 and ci != cout:
            b["wd"] = mk((ci, cout))
            b["bd"] = mk((1, cout))
        blocks.append(b)
    return blocks


@pytest.mark.parametrize("h,w", [(6, 10), (5, 7), (8, 8)])
@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_bottleneck_stack_vs_pallas(h, w, dtype, rtol):
    rng = np.random.default_rng(0)
    n, cin, cmid, cout = 2, 24, 16, 32
    blocks = _mk_blocks(rng, cin, cmid, cout, 3)
    x = rng.standard_normal((n, h * w, cin)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jblocks = [{k: jnp.asarray(v).astype(jnp.float32 if k[0] == "b" else jdt)
                for k, v in b.items()} for b in blocks]
    want = np.asarray(jstack(jnp.asarray(x).astype(jdt), jblocks, h=h, w=w,
                             interpret=True)).astype(np.float32)
    tblocks = [{k: torch.from_numpy(v).to(torch.float32 if k[0] == "b"
                                          else tdt)
                for k, v in b.items()} for b in blocks]
    got = bottleneck.fused_bottleneck_stack(
        torch.from_numpy(x).to(tdt), tblocks, h=h, w=w)
    assert got.dtype == tdt and tuple(got.shape) == (n, h * w, cout)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=rtol)


def test_bottleneck_stack_refuses_inconsistent_blocks():
    rng = np.random.default_rng(1)
    blocks = [{k: torch.from_numpy(v) for k, v in b.items()}
              for b in _mk_blocks(rng, 8, 4, 16, 1)]
    del blocks[0]["wd"], blocks[0]["bd"]  # 8 -> 16 without a projection
    with pytest.raises(ValueError):
        bottleneck.fused_bottleneck_stack(torch.zeros(1, 9, 8), blocks,
                                          h=3, w=3)
    with pytest.raises(ValueError):
        bottleneck.fused_bottleneck_stack(torch.zeros(1, 10, 8), blocks,
                                          h=3, w=3)


# ------------------------------------------------------------------ matcher

def _episodes(e=4, q=10, n=5, m=3, d=128, seed=0):
    rng = np.random.default_rng(seed)
    query = rng.standard_normal((e, q, d)).astype(np.float32)
    support = rng.standard_normal((e, n, m, d)).astype(np.float32)
    mask = (rng.random((e, n, m)) > 0.3).astype(np.float32)
    mask[..., 0] = 1.0
    return query, support, mask


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("fusion", ["max", "mean"])
def test_matcher_vs_pallas_and_xla(metric, fusion):
    q, s, m = _episodes()
    jargs = tuple(map(jnp.asarray, (q, s, m)))
    targs = tuple(map(torch.from_numpy, (q, s, m)))
    got = similarity.episode_class_scores(*targs, metric=metric,
                                          fusion=fusion).numpy()
    want_kernel = np.asarray(jscores(*jargs, metric=metric, fusion=fusion,
                                     interpret=True))
    want_xla = np.asarray(jsim.fused_class_scores(*jargs, metric=metric,
                                                  fusion=fusion))
    # atol for cosine scores in [-1, 1]; euclidean scores are ~ -2D, so
    # the same bound is relative there (f32 sums in another order).
    np.testing.assert_allclose(got, want_kernel, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_xla, rtol=1e-5, atol=1e-5)
    plain = similarity.fused_class_scores(*targs, metric=metric,
                                          fusion=fusion).numpy()
    np.testing.assert_allclose(plain, want_xla, rtol=1e-5, atol=1e-5)


def test_predict_matches_xla():
    q, s, m = _episodes(e=6, q=8, n=5, m=2, seed=1)
    want = np.asarray(jsim.predict(*map(jnp.asarray, (q, s, m))))
    got = similarity.predict(*map(torch.from_numpy, (q, s, m))).numpy()
    np.testing.assert_array_equal(got, want)


def test_ops_refuse_other_devices():
    """Only a CPU tensor takes the plain version; anything else that is not
    CUDA raises instead of being computed somewhere else."""
    meta = torch.empty(1, 64, 64, 3, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        crop_normalize.crop_normalize(meta, crop=32)
    with pytest.raises(ValueError):
        crop_normalize.crop_normalize_cuda(
            torch.zeros(1, 64, 64, 3, dtype=torch.uint8), crop=32)
    q, s, m = (torch.from_numpy(a) for a in _episodes())
    with pytest.raises(ValueError):
        similarity.episode_scores_cuda(q, s, m)
