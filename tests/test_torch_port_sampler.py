"""The port's threefry PRNG and episode sampler, bitwise against jax.random.

The installed JAX runs threefry with ``jax_threefry_partitionable`` on,
which sets how split, fold_in and random_bits lay out their counters; the
port must reproduce those bits exactly so both packages score the same
episode sequence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eov_tpu import episodes as jep
from eov_tpu_torch import episodes as tep
from eov_tpu_torch import prng

SEEDS = [0, 1, 7, 42, 12345, 2**31 - 1]


def _keys(seeds):
    jk = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    tk = torch.stack([prng.key(s) for s in seeds])
    np.testing.assert_array_equal(np.asarray(jk).astype(np.int64),
                                  tk.numpy())
    return jk, tk


def test_fold_in_bitwise():
    jk, tk = _keys(SEEDS)
    data = np.array([0, 1, 2, 63, 64, 599, 10_000, 2**31 - 1], np.int32)
    want = jax.vmap(lambda k: jax.vmap(
        lambda d: jax.random.fold_in(k, d))(jnp.asarray(data)))(jk)
    got = prng.fold_in(tk[:, None, :].expand(-1, len(data), 2),
                       torch.from_numpy(data.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                  got.numpy())


@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_bitwise(num):
    jk, tk = _keys(SEEDS)
    want = jax.vmap(lambda k: jax.random.split(k, num))(jk)
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                  prng.split(tk, num).numpy())


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 12), (5, 64)])
def test_uniform_bitwise(shape):
    jk, tk = _keys(SEEDS)
    # keys derived the way the sampler derives them
    jk = jax.vmap(lambda k: jax.random.fold_in(k, 3))(jk)
    tk = prng.fold_in(tk, 3)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(jk))
    got = prng.uniform(tk, shape).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed,base,counts,n_way,k_shot,n_query", [
    (0, 0, [6, 6, 6, 6, 6, 6], 5, 1, 1),
    (3, 17, [5, 3, 6, 1, 6, 4, 6, 2], 3, 1, 2),      # ragged, ineligible
    (7, 1000, [2, 9, 0, 9, 4, 9, 9, 1, 7], 4, 2, 2),  # empty class too
    (11, 64, [3] * 20, 5, 1, 1),                      # more classes
])
def test_sample_episodes_equal(seed, base, counts, n_way, k_shot, n_query):
    counts = np.asarray(counts, np.int32)
    max_clips = int(counts.max())
    want = jep.sample_episodes(
        jax.random.PRNGKey(seed), jnp.asarray(counts), n_way=n_way,
        k_shot=k_shot, n_query=n_query, n_episodes=40, max_clips=max_clips,
        base_ordinal=base)
    got = tep.sample_episodes(
        prng.key(seed), torch.from_numpy(counts), n_way=n_way,
        k_shot=k_shot, n_query=n_query, n_episodes=40, max_clips=max_clips,
        base_ordinal=base)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    need = k_shot + n_query
    assert bool((torch.from_numpy(counts)[got.class_ids] >= need).all())


def test_sampler_refuses_impossible_protocols():
    counts = torch.tensor([3, 3])
    with pytest.raises(ValueError):
        tep.sample_episodes(prng.key(0), counts, n_way=3, k_shot=1,
                            n_query=1, n_episodes=1, max_clips=3)
    with pytest.raises(ValueError):
        tep.sample_episodes(prng.key(0), counts, n_way=2, k_shot=3,
                            n_query=1, n_episodes=1, max_clips=3)


def test_query_labels():
    np.testing.assert_array_equal(
        np.asarray(jep.query_labels(4, 3)), tep.query_labels(4, 3).numpy())
