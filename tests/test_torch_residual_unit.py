"""Port K2's plain version (the ResidualUnit as the port computes it on the
CPU) against the JAX Pallas kernel in interpret mode and the JAX XLA unit.

The CUDA kernel is held against this plain version on the card by
chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.models.bigcodec import _AA, residual_unit as jax_residual_unit
from audiotokenization_tpu.ops.conv import init_wn_conv1d
from audiotokenization_tpu.ops.pallas.residual_unit_kernel import fused_residual_unit as jax_fused
from audiotokenization_tpu.ops.snake import init_snake_beta
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.models import bigcodec as TB
from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import fused_residual_unit

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: parallel test workers share the cores, and idle
    threads of an oversubscribed pool spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_params(C):
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    p = {"snake1": init_snake_beta(C), "conv1": init_wn_conv1d(k1, C, C, 7, torch_default=True),
         "snake2": init_snake_beta(C), "conv2": init_wn_conv1d(k2, C, C, 1, torch_default=True)}
    for i, (s, name) in enumerate([("snake1", "alpha"), ("snake1", "beta"),
                                   ("snake2", "alpha"), ("snake2", "beta")]):
        p[s][name] = 0.1 * jax.random.normal(jax.random.fold_in(k3, i), (C,))
    return p


def _port_unit(params, C):
    unit = TB.ResidualUnit(C, generator=torch.Generator().manual_seed(0))
    unit.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return unit


@pytest.mark.parametrize("C,T,dilation,pallas", [
    (128, 512, 1, True),
    (128, 700, 3, True),   # T not a multiple of the TPU kernel's tile
    (256, 1024, 9, True),
    (768, 200, 9, False),  # the width the TPU kernel could not take
])
def test_plain_residual_unit_matches_jax(C, T, dilation, pallas):
    params = _jax_params(C)
    x = np.array(jax.random.normal(jax.random.key(1), (2, C, T), jnp.float32))
    with torch.no_grad():
        got = TB.residual_unit(torch.from_numpy(x), _port_unit(params, C),
                               dilation=dilation).numpy()
    oracle = jax_residual_unit(jnp.asarray(x), params, dilation=dilation, causal=False,
                               aa=_AA(antialias=False))
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=TOL, atol=TOL)
    if pallas:
        fused = jax_fused(jnp.asarray(x), params, dilation=dilation, interpret=True, version=4)
        np.testing.assert_allclose(got, np.asarray(fused), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("version", [1, 3, 5])
def test_plain_residual_unit_matches_other_pallas_versions(version):
    """K2 replaces all five schedules; v4 is held above, v1, v3 and v5 here."""
    C, T, dilation = 16, 300, 3
    params = _jax_params(C)
    x = np.array(jax.random.normal(jax.random.key(2), (2, C, T), jnp.float32))
    with torch.no_grad():
        got = TB.residual_unit(torch.from_numpy(x), _port_unit(params, C),
                               dilation=dilation).numpy()
    fused = jax_fused(jnp.asarray(x), params, dilation=dilation, interpret=True,
                      version=version)
    np.testing.assert_allclose(got, np.asarray(fused), rtol=TOL, atol=TOL)


def test_fused_residual_unit_refuses_a_device_it_has_no_kernel_for():
    """Only CPU tensors take the plain version; anything else launches or raises."""
    C = 8
    x = torch.empty(1, C, 16, device="meta")
    w7, w1 = torch.empty(C, C, 7, device="meta"), torch.empty(C, C, 1, device="meta")
    vecs = [torch.empty(C, device="meta") for _ in range(6)]
    with pytest.raises(ValueError):
        fused_residual_unit(x, w7, vecs[0], w1, vecs[1], *vecs[2:], dilation=1)
