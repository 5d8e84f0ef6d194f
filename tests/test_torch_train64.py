"""Are the port's training updates off JAX's by rounding only? The tiny
config's first 3 steps in float64 on both sides.

tests/test_torch_train.py holds the float32 updates at steps 1-2 within
3e-3 x max |update| (1e-3 at step 0): the encoder's snake α/β carry
gradients that are sums with heavy cancellation. Here the port's step runs
on ``.double()`` modules and batch, and JAX's ``make_train_step`` under
``jax.enable_x64(True)`` on a float64 state. Both packages pin float32 in
the same places: the VQ (its input projection, distance and lookup; the
quantizer's parameters stay float32 on both sides), the STFT of the mel
loss and the spectrogram discriminator, and the GAN losses' sums. In
float64 the updates agree within the 1e-3 the float32 comparison was first
asked to meet, at every step. In float32 JAX's own step moves the same
snake updates by up to 1.43e-3 x max |update| away from its float64 step
(measured on these inputs), more than the port's float32 step differs from
JAX's: the 3e-3 of the float32 test covers float32 rounding through the
pinned islands, not a fault. The snake's own gradient is checked by
gradcheck in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.train.state import init_train_state as jax_init_train_state
from audiotokenization_tpu.train.state import make_optimizers as jax_make_optimizers
from audiotokenization_tpu_torch.convert import train_state_from_jax
from audiotokenization_tpu_torch.ops.snake import snake_beta
from audiotokenization_tpu_torch.train.state import train_state
from audiotokenization_tpu_torch.train.step import make_train_step

from test_torch_train import (N_STEPS, UPDATE_ATOL, batches, hold_update, leaves, port_cfg,
                              run_jax, smooth, tiny)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f64(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float64)
                        if getattr(x, "dtype", None) == jnp.float32 else x, tree)


@pytest.fixture(scope="module")
def float64_steps():
    """(JAX, port) per step: (metrics, leaves before, leaves after), the
    smooth tiny config (AdamW eps 1, no warmup), 3 batches."""
    jcfg = smooth(tiny())
    state = jax.jit(lambda k: jax_init_train_state(k, tiny()))(jax.random.key(0))
    wavs = batches(seed=1)
    with jax.enable_x64(True):
        gen = {**_f64(state.gen_params), "quantizer": state.gen_params["quantizer"]}
        gen_tx, disc_tx = jax_make_optimizers(jcfg)
        disc = _f64(state.disc_params)
        jstate = state._replace(gen_params=gen, disc_params=disc,
                                gen_opt_state=gen_tx.init(gen), disc_opt_state=disc_tx.init(disc))
        jax_out = run_jax(jcfg, jstate, [w.astype(np.float64) for w in wavs])
    cfg = port_cfg(jcfg)
    start = train_state_from_jax(jax.tree.map(np.asarray, state), cfg, device="cpu")
    start.gen.double()
    start.gen.quantizer.float()
    port = train_state(cfg, start.gen, start.disc.double())
    step = make_train_step(cfg, device="cpu")
    port_out = []
    for w in wavs:
        before = leaves(port)
        m = step(port, {"wav": torch.from_numpy(w).double()})
        port_out.append(({k: np.asarray(v) for k, v in m.items()}, before, leaves(port)))
    return jax_out, port_out


@pytest.mark.parametrize("k", range(N_STEPS))
def test_float64_updates_match_jax_within_1e3(float64_steps, k):
    (jm, jb, ja), (pm, pb, pa) = float64_steps[0][k], float64_steps[1][k]
    assert pa.keys() == ja.keys()
    assert pa["gen.encoder.conv_in.v"].dtype == ja["gen.encoder.conv_in.v"].dtype == np.float64
    assert pa["gen.quantizer.layers.0.codebook"].dtype == np.float32
    np.testing.assert_allclose(float(pm["gen_loss"]), float(jm["gen_loss"]), rtol=1e-6)
    for name in ja:
        hold_update(name, (pb[name], pa[name]), (jb[name], ja[name]), UPDATE_ATOL)


@pytest.mark.parametrize("shape", [(2, 3, 17), (1, 5, 9)])
def test_snake_gradcheck_float64(shape):
    g = torch.Generator().manual_seed(shape[2])
    x = torch.randn(shape, generator=g, dtype=torch.float64, requires_grad=True)
    alpha = (0.3 * torch.randn(shape[1], generator=g, dtype=torch.float64)).requires_grad_()
    beta = (0.3 * torch.randn(shape[1], generator=g, dtype=torch.float64)).requires_grad_()
    assert torch.autograd.gradcheck(snake_beta, (x, alpha, beta))
