"""Kernel 3's plain version (``ops/similarity.py:episode_scores_plain``,
the CPU path of ``episode_class_scores``) at the shapes its kernel splits
by, against a float64 numpy version of the same definition: cosine of
rsqrt-normalized rows or the negative squared distance, masked members
dropped, the max over each class's members. CPU only."""

import numpy as np
import pytest
import torch

from eov_tpu_torch.ops import similarity

# (E, Q, N, M, D): the protocol, the embodied eval (1 real + 5 virtual
# members, masked), one episode, 67 episodes of 10 queries (two query
# tiles of the kernel), and a classify chunk at MAX_ROWS rows (half the
# rows for the store). D is cut from 2048 to keep the test small.
SHAPES = [(64, 5, 5, 1, 64), (64, 5, 5, 6, 64), (1, 5, 5, 1, 64),
          (67, 10, 5, 3, 32),
          (1, similarity.MAX_ROWS // 2, similarity.MAX_ROWS // 2, 1, 8)]


def _oracle(q, s, mask, metric):
    e, n, m, d = s.shape
    flat = s.reshape(e, n * m, d)
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        flat = flat / np.linalg.norm(flat, axis=-1, keepdims=True)
        sims = q @ flat.transpose(0, 2, 1)
    else:
        sims = (2.0 * q @ flat.transpose(0, 2, 1)
                - (q * q).sum(-1)[:, :, None]
                - (flat * flat).sum(-1)[:, None, :])
    sims = sims.reshape(e, q.shape[1], n, m)
    sims = np.where(mask[:, None] > 0, sims, -np.inf)
    return sims.max(axis=-1)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("e,q,n,m,d", SHAPES)
def test_episode_scores_plain_shapes(e, q, n, m, d, metric):
    rng = np.random.default_rng(e + q + n + m)
    query = rng.standard_normal((e, q, d)).astype(np.float32)
    support = rng.standard_normal((e, n, m, d)).astype(np.float32)
    mask = (rng.random((e, n, m)) > 0.4).astype(np.float32)
    mask[..., 0] = 1  # every class keeps a member
    got = similarity.episode_class_scores(
        torch.from_numpy(query), torch.from_numpy(support),
        torch.from_numpy(mask), metric=metric)
    assert got.shape == (e, q, n) and got.dtype == torch.float32
    want = _oracle(query.astype(np.float64), support.astype(np.float64),
                   mask, metric)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
