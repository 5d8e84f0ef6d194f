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
from audiotokenization_tpu_torch.ops.cuda.vq_kernel import vq_argmin


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
