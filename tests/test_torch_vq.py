"""Port K1's plain version and the factorized VQ against the JAX package.

On the CPU ``vq_argmin`` computes its plain version; the CUDA kernel is held
against that plain version on the card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.models.quantizers import factorized_vq as JQ
from audiotokenization_tpu.ops.pallas.vq_kernel import vq_argmin as jax_vq_argmin
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.models.quantizers import factorized_vq as TQ
from audiotokenization_tpu_torch.ops.cuda.vq_kernel import (k1_geometry, k1_shares, l2_normalize,
                                                           vq_argmin)


def _case(name):
    if name == "700x8 vs 8192x8":
        rng = np.random.RandomState(0)
        return rng.randn(700, 8).astype(np.float32), rng.randn(8192, 8).astype(np.float32)
    if name == "37x8 vs 128x8":
        rng = np.random.RandomState(1)
        return rng.randn(37, 8).astype(np.float32), rng.randn(128, 8).astype(np.float32)
    rng = np.random.RandomState(2)  # duplicated rows: ties go to the lowest index
    half = rng.randn(64, 8).astype(np.float32)
    return rng.randn(50, 8).astype(np.float32), np.concatenate([half, half], axis=0)


@pytest.mark.parametrize("name", ["700x8 vs 8192x8", "37x8 vs 128x8", "duplicated codes"])
def test_plain_argmin_equals_jax_exactly(name):
    enc, cb = _case(name)
    got = vq_argmin(torch.from_numpy(enc), torch.from_numpy(cb))
    assert got.dtype == torch.int32
    oracle = np.asarray(JQ.nearest_code_indices(jnp.asarray(enc.T)[None], jnp.asarray(cb),
                                                use_pallas=False))[0]
    pallas = np.asarray(jax_vq_argmin(jnp.asarray(enc), jnp.asarray(cb), interpret=True))
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(got.numpy(), pallas)
    port = TQ.nearest_code_indices(torch.from_numpy(enc.T.copy())[None], torch.from_numpy(cb))
    np.testing.assert_array_equal(port.numpy()[0], oracle)
    if name == "duplicated codes":
        assert (got < 64).all()


def test_vq_argmin_refuses_a_device_it_has_no_kernel_for():
    """Only CPU tensors take the plain version; anything else launches or raises."""
    enc, cb = torch.empty(4, 8, device="meta"), torch.empty(16, 8, device="meta")
    with pytest.raises(ValueError):
        vq_argmin(enc, cb)


@pytest.mark.parametrize("d", [8, 32])
@pytest.mark.parametrize("n", [1, 5, 128, 1000, 8192, 8193, 65536])
@pytest.mark.parametrize("m", [1, 37, 700, 2560, 100000])
def test_k1_geometry_covers_every_row_and_code(m, n, d):
    """The cluster layout the kernel is launched with: the blocks' shares
    cover [0, N) once, in index order, none empty; the clusters' rows cover
    [0, M); S <= 8; the shared memory fits a block."""
    g = k1_geometry(m, n, d)
    assert 1 <= g.cluster_size <= 8 and g.cluster_size <= n
    shares = k1_shares(g, n)
    assert shares[0][0] == 0 and shares[-1][1] == n
    assert all(lo < hi for lo, hi in shares)
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    assert g.clusters * g.rows >= m > (g.clusters - 1) * g.rows
    assert g.d % 8 == 0 and g.d >= d and g.rows % 16 == 0
    assert 1 <= g.tile <= g.share and g.buffers == (1 if g.share <= g.tile else 2)
    assert g.smem_bytes <= 232_448


def _ordered_keys(dist):
    """The kernel's 64-bit keys, ordered_bits(dist) << 32 | index, shifted
    down by 2^63 so that they fit int64 in the same order."""
    u = dist.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ordered = torch.where(u >= 2 ** 31, 0xFFFFFFFF - u, u + 2 ** 31)  # ~u, or u | 2^31
    return (ordered - 2 ** 31) * 2 ** 32 + torch.arange(dist.shape[1], dtype=torch.int64)


def _two_level_argmin(enc, cb):
    """The kernel's reduction in PyTorch: per cluster of rows, the minimum key
    within each block's share of the codes, then across the shares."""
    e, c = l2_normalize(torch.from_numpy(enc)), l2_normalize(torch.from_numpy(cb))
    dist = (torch.sum(e * e, dim=1, keepdim=True) - 2.0 * (e @ c.T)
            + torch.sum(c * c, dim=1)[None, :])
    keys = _ordered_keys(dist)
    g = k1_geometry(len(enc), *cb.shape)
    out = torch.empty(len(enc), dtype=torch.int64)
    for k in range(g.clusters):
        rows = keys[k * g.rows:(k + 1) * g.rows]
        per_share = torch.stack([rows[:, lo:hi].min(dim=1).values
                                 for lo, hi in k1_shares(g, cb.shape[0])], dim=1)
        out[k * g.rows:(k + 1) * g.rows] = per_share.min(dim=1).values & 0xFFFFFFFF
    return out.to(torch.int32).numpy(), dist


def _reduction_case(name):
    """enc, codebook, and the indices each row must get where the case fixes them."""
    rng = np.random.RandomState(4)
    book = rng.randn(8192, 8).astype(np.float32)
    if name == "duplicates across shares":  # code i == code i + 4096, four shares apart
        enc = rng.randn(700, 8).astype(np.float32)
        return enc, np.concatenate([book[:4096], book[:4096]]), None
    if name == "rows equal to codes":  # distances near 0, some below
        picked = rng.choice(len(book), 512, replace=False)
        return book[picked], book, picked
    return (*_case("700x8 vs 8192x8"), None)


@pytest.mark.parametrize("name", ["duplicates across shares", "rows equal to codes",
                                  "700x8 vs 8192x8"])
def test_two_level_reduction_equals_jax_exactly(name):
    """Minimum keys within each share, then across shares, give the JAX
    oracle's and the Pallas K1's indices exactly, ties to the lowest index."""
    enc, cb, want = _reduction_case(name)
    g = k1_geometry(len(enc), len(cb), cb.shape[1])
    assert g.cluster_size == 8 and g.clusters > 1
    got, dist = _two_level_argmin(enc, cb)
    oracle = np.asarray(JQ.nearest_code_indices(jnp.asarray(enc.T)[None], jnp.asarray(cb),
                                                use_pallas=False))[0]
    pallas = np.asarray(jax_vq_argmin(jnp.asarray(enc), jnp.asarray(cb), interpret=True))
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, pallas)
    if name == "duplicates across shares":
        assert (got < 4096).all()
    if want is not None:
        np.testing.assert_array_equal(got, want)
        assert (dist.min(dim=1).values <= 0).any()  # ordered_bits must order these below 0


def _quantizers(num_quantizers):
    tree = JQ.init_residual_vq(jax.random.key(num_quantizers), num_quantizers=num_quantizers,
                               dim=32, codebook_size=64, codebook_dim=8)
    port = TQ.ResidualVQ(num_quantizers=num_quantizers, dim=32, codebook_size=64,
                         codebook_dim=8, generator=torch.Generator().manual_seed(0))
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)))
    return tree, port


@pytest.mark.parametrize("num_quantizers,training", [(1, False), (2, False), (2, True)])
def test_residual_vq_apply_matches_jax(num_quantizers, training):
    tree, port = _quantizers(num_quantizers)
    x = np.random.RandomState(5).randn(2, 32, 37).astype(np.float32)
    zq, idx, loss = JQ.residual_vq_apply(tree, jnp.asarray(x), num_quantizers=num_quantizers,
                                         training=training, use_pallas=False)
    with torch.no_grad():
        tzq, tidx, tloss = TQ.residual_vq_apply(port, torch.from_numpy(x),
                                                num_quantizers=num_quantizers,
                                                training=training)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(tzq.numpy(), np.asarray(zq), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(loss), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("proj", [True, False])
def test_residual_vq_codes_to_emb_matches_jax(proj):
    tree, port = _quantizers(2)
    codes = np.random.RandomState(6).randint(0, 64, size=(2, 11, 2)).astype(np.int32)
    ref = JQ.residual_vq_codes_to_emb(tree, jnp.asarray(codes), proj=proj)
    with torch.no_grad():
        got = TQ.residual_vq_codes_to_emb(port, torch.from_numpy(codes), proj=proj)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
