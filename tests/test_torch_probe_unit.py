"""Port P1's plain version (the time-major probe unit of scripts/probe_v5.py)
against a JAX transcription of the probe's XLA oracle ``xla_unit``.

``xla_unit`` and the probe's Pallas ``make_call`` are local to the script's
``main()``, so the oracle is transcribed here as it stands there
(probe_v5.py:101-111), with the weights related as probe_v5.py:130-131. The
CUDA kernel is held against this plain version on the card by
chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu_torch.ops.cuda.probe_unit_kernel import probe_unit, probe_unit_plain

TOL = 1e-5
HP = jax.lax.Precision.HIGHEST


def xla_unit(x, w7o, w1o, dilation=3):
    # probe_v5.py:101-111: x is (B, C, T), weights OIH
    y = jnp.sin(x)
    y = jax.lax.conv_general_dilated(
        y, w7o, (1,), [(3 * dilation, 3 * dilation)], rhs_dilation=(dilation,),
        dimension_numbers=("NCH", "OIH", "NCH"), precision=HP)
    y = jnp.sin(y)
    y = jax.lax.conv_general_dilated(
        y, w1o, (1,), [(0, 0)], dimension_numbers=("NCH", "OIH", "NCH"), precision=HP)
    return x + y


def _inputs(C, T, seed=0):
    rng = np.random.RandomState(seed)
    x_nch = rng.randn(2, C, T).astype(np.float32) * 0.1
    w7o = rng.randn(C, C, 7).astype(np.float32) * 0.05
    w1o = rng.randn(C, C, 1).astype(np.float32) * 0.05
    w7t = np.transpose(w7o, (2, 1, 0)).reshape(7 * C, C)  # probe_v5.py:130
    w1t = w1o[:, :, 0].T                                   # probe_v5.py:131
    return x_nch, w7o, w1o, np.ascontiguousarray(w7t), np.ascontiguousarray(w1t)


@pytest.mark.parametrize("dilation", [1, 3])
@pytest.mark.parametrize("T", [100, 517])
@pytest.mark.parametrize("C", [8, 48])
def test_plain_probe_unit_matches_xla_unit(C, T, dilation):
    x_nch, w7o, w1o, w7t, w1t = _inputs(C, T)
    x_tmj = np.ascontiguousarray(np.swapaxes(x_nch, 1, 2))
    oracle = np.swapaxes(np.asarray(xla_unit(jnp.asarray(x_nch), jnp.asarray(w7o),
                                             jnp.asarray(w1o), dilation)), 1, 2)
    args = [torch.from_numpy(a) for a in (x_tmj, w7t, w1t)]
    plain = probe_unit_plain(*args, dilation=dilation).numpy()
    assert plain.shape == (2, T, C)
    np.testing.assert_allclose(plain, oracle, rtol=TOL, atol=TOL)
    # on CPU tensors the wrapper is the plain version
    np.testing.assert_array_equal(probe_unit(*args, dilation=dilation).numpy(), plain)


def test_probe_unit_refuses_a_device_it_has_no_kernel_for():
    """Only CPU tensors take the plain version; anything else launches or raises."""
    C = 8
    x = torch.empty(1, 16, C, device="meta")
    w7t, w1t = torch.empty(7 * C, C, device="meta"), torch.empty(C, C, device="meta")
    with pytest.raises(ValueError):
        probe_unit(x, w7t, w1t, dilation=3)
