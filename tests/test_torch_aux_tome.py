"""The port's auxiliary blocks (``ops/aux_blocks.py``) and token merging
(``utils/tome.py``) against the JAX package's:

- ``eca`` and ``scale_bias`` within 1e-6; ``init_eca`` / ``init_scale_bias``
  shapes;
- ``drop_path`` with a handed-in keep mask equal to JAX's with the same
  mask, the identity at rate 0 or outside training, and its keep
  statistics from a ``torch.Generator``;
- ``adjacent_chained_merge`` / ``unmerge`` on random input and on runs of
  identical tokens (ties, where the lower link index wins, as in
  ``jax.lax.top_k``), with r <= 0 and r >= N: the groups equal as
  integers, the merged values within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.ops import aux_blocks as JA
from audiotokenization_tpu.utils import tome as JT
from audiotokenization_tpu_torch.ops import aux_blocks as TA
from audiotokenization_tpu_torch.utils import tome as TT

TOL = 1e-6


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("k", [3, 5])
def test_eca_matches_jax(k):
    x, w = rand(2, 12, 17), rand(1, 1, k, seed=1)
    want = np.asarray(JA.eca(jnp.asarray(x), jnp.asarray(w), kernel_size=k))
    got = TA.eca(torch.from_numpy(x), torch.from_numpy(w), kernel_size=k).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    p = TA.init_eca(torch.Generator().manual_seed(0), k)
    assert p["w"].shape == (1, 1, k) and p["w"].abs().max() <= 1 / np.sqrt(k)


def test_scale_bias_matches_jax():
    x, s, b = rand(2, 5, 8), rand(8, seed=1), rand(8, seed=2)
    want = np.asarray(JA.scale_bias(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    got = TA.scale_bias(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    p, jp = TA.init_scale_bias(8, adaptive=False), JA.init_scale_bias(8, adaptive=False)
    assert torch.equal(p["scale"], torch.ones(8)) and torch.equal(p["bias"], torch.zeros(8))
    assert p["adaptive"] is jp["adaptive"] is False


@pytest.mark.parametrize("scale_by_keep", [True, False])
def test_drop_path_with_jax_mask(scale_by_keep):
    """JAX's own bernoulli draw, handed in as the keep mask."""
    x = rand(6, 3, 4)
    rng = jax.random.key(3)
    want = np.asarray(JA.drop_path(jnp.asarray(x), rate=0.5, rng=rng,
                                   scale_by_keep=scale_by_keep))
    keep = np.asarray(jax.random.bernoulli(rng, 0.5, (6, 1, 1))).reshape(6)
    assert 0 < keep.sum() < 6  # the draw keeps some and drops some
    got = TA.drop_path(torch.from_numpy(x), rate=0.5, keep_mask=torch.tensor(keep),
                       scale_by_keep=scale_by_keep).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_drop_path_identity_and_statistics():
    x = torch.from_numpy(rand(4, 3))
    assert TA.drop_path(x, rate=0.0) is x
    assert TA.drop_path(x, rate=0.3, training=False) is x
    g = torch.Generator().manual_seed(0)
    ones = torch.ones(20000, 2)
    out = TA.drop_path(ones, rate=0.25, generator=g)
    kept = out[:, 0] > 0
    assert torch.equal(out[:, 0], out[:, 1])  # one draw per sample
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.75))
    frac = kept.float().mean().item()
    assert abs(frac - 0.75) < 4 * np.sqrt(0.75 * 0.25 / 20000), frac
    assert abs(out.mean().item() - 1.0) < 0.02  # scale_by_keep keeps the mean
    again = TA.drop_path(ones, rate=0.25, generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)


def jax_merge(x, r):
    merged, info = JT.adjacent_chained_merge(jnp.asarray(x), r)
    return (np.asarray(merged), np.asarray(info.group_of), np.asarray(info.n_groups),
            np.asarray(info.mask), np.asarray(JT.unmerge(merged, info)))


def hold_merge(x, r):
    m, g, n, mask, un = jax_merge(x, r)
    merged, info = TT.adjacent_chained_merge(torch.from_numpy(x), r)
    assert np.array_equal(info.group_of.numpy(), g)
    assert np.array_equal(info.n_groups.numpy(), n)
    assert np.array_equal(info.mask.numpy(), mask)
    np.testing.assert_allclose(merged.numpy(), m, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(TT.unmerge(merged, info).numpy(), un, rtol=TOL, atol=TOL)
    return info


@pytest.mark.parametrize("r", [-1, 0, 1, 3, 9, 10, 25])
def test_merge_random_matches_jax(r):
    info = hold_merge(rand(3, 10, 4, seed=r + 5), r)
    assert int(info.n_groups[0]) == (10 if r <= 0 else 10 - min(r, 9))


def test_merge_identical_runs_ties_match_jax():
    """Runs of one token make equal similarities (ties, bit for bit on
    each side): the lower link index is taken first, as in jax.lax.top_k."""
    x = rand(2, 12, 8, seed=1)
    x[0, 2] = x[0, 3] = x[0, 4] = x[0, 1]   # links 1-3 tie
    x[0, 7] = x[0, 8] = x[0, 9] = x[0, 1]   # and links 7, 8 with them
    x[1, :] = x[1, 0]                       # every link ties
    for r in (2, 3, 4, 6):
        info = hold_merge(x, r)
        g = info.group_of.numpy()
        assert len(set(g[0, 1:min(r, 3) + 2])) == 1  # the lower run merges first
        # in the all-equal row the first r links are taken: tokens 0..r merge
        assert (g[1, :r + 1] == 0).all() and g[1, r + 1] == 1
