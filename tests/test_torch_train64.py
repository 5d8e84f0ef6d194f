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

The same holds from the port's own initial weights (JAX's state built
from them, ``test_torch_conformer_train.py::states``), where the float32
comparison of tests/test_torch_train.py misses its bounds by up to 24x on
the encoder's snake α/β:

- with the islands lifted as well (``lifted``: patched at runtime in this
  process, nothing of either package edited: the quantizer's parameters,
  the VQ's distance, the STFTs' input, window and mel filters and the GAN
  losses' sums all in float64), the two float64 steps from port seed 0
  agree within the same 1e-3 at every step (worst 1.1e-3 x max |update|
  at a single element against 0.44-0.67% with the islands pinned);
- with the islands pinned, the port's float32 step is no farther from
  JAX's float64 step than 2x JAX's own float32 step is (the precision
  rule's form; each leaf's error less twice the parameters' float32
  spacing, over max |update|, the worst leaf), on port seeds 0 and 1.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.train.state import init_train_state as jax_init_train_state
from audiotokenization_tpu.train.state import make_optimizers as jax_make_optimizers
from audiotokenization_tpu.train.step import make_train_step as jax_make_train_step
from audiotokenization_tpu_torch.convert import train_state_from_jax
from audiotokenization_tpu_torch.ops.snake import snake_beta
from audiotokenization_tpu_torch.train.state import train_state
from audiotokenization_tpu_torch.train.step import make_train_step

from test_torch_conformer_train import states
from test_torch_train import (N_STEPS, UPDATE_ATOL, batches, hold_update, jax_leaves, leaves,
                              port_cfg, smooth, tiny)

FP32_RATIO = 2.0  # port fp32 vs JAX float64, over JAX fp32 vs JAX float64


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
def jax_step64():
    """JAX's step of the smooth tiny config, jitted once for the float64 runs
    with the islands pinned."""
    return jax.jit(jax_make_train_step(smooth(tiny())))


@pytest.fixture(scope="module")
def float64_steps(jax_step64):
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
        jax_out = _jax_steps(jax_step64, jstate, [w.astype(np.float64) for w in wavs])
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


def _jax_steps(step, state, wavs):
    out = []
    for w in wavs:
        before = jax_leaves(state)
        state, m = step(state, {"wav": jnp.asarray(w)})
        out.append(({k: np.asarray(v) for k, v in m.items()}, before, jax_leaves(state)))
    return out


def _port_steps(cfg, state, wavs, dtype=torch.float32):
    step = make_train_step(cfg, device="cpu")
    out = []
    for w in wavs:
        before = leaves(state)
        m = step(state, {"wav": torch.from_numpy(w).to(dtype)})
        out.append(({k: np.asarray(v) for k, v in m.items()}, before, leaves(state)))
    return out


def _f64_state(jstate, jcfg, *, quantizer_f64: bool):
    gen = _f64(jstate.gen_params)
    if not quantizer_f64:
        gen = {**gen, "quantizer": jstate.gen_params["quantizer"]}
    disc = _f64(jstate.disc_params)
    gen_tx, disc_tx = jax_make_optimizers(jcfg)
    return jstate._replace(gen_params=gen, disc_params=disc, gen_opt_state=gen_tx.init(gen),
                           disc_opt_state=disc_tx.init(disc))


class _Float32IsFloat64(types.ModuleType):
    """A module's ``jnp`` whose ``float32`` is float64."""

    def __init__(self):
        super().__init__("jax.numpy")

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _plain_argmin64(enc, codebook, interpret=None):
    """The VQ's normalised-distance argmin at the inputs' precision."""
    def unit(x):
        return x / jnp.maximum(jnp.linalg.norm(x, axis=1, keepdims=True), 1e-12)

    e, c = unit(enc), unit(codebook)
    dist = jnp.sum(e * e, 1, keepdims=True) - 2 * e @ c.T + jnp.sum(c * c, 1)[None]
    return jnp.argmax(-dist, axis=1).astype(jnp.int32)


def _lift_islands(mp: pytest.MonkeyPatch):
    """Both packages' float32 islands of the step at float64, for ``mp``'s
    lifetime: JAX's casts to ``jnp.float32`` (STFT, GAN losses, the VQ's
    distance) and its windows and mel filters, the Pallas VQ replaced by
    the plain argmin; the port's ``.float()`` a no-op on float64 tensors,
    its window and mel filters float64 and its VQ argmin the plain one."""
    import audiotokenization_tpu.losses.gan as jgan
    import audiotokenization_tpu.losses.mel as jmel
    import audiotokenization_tpu.models.quantizers.factorized_vq as jfvq
    import audiotokenization_tpu.ops.pallas.vq_kernel as jvq
    import audiotokenization_tpu.ops.stft as jstft
    import audiotokenization_tpu_torch.losses.mel as tmel
    import audiotokenization_tpu_torch.models.quantizers.factorized_vq as tfvq
    import audiotokenization_tpu_torch.ops.stft as tstft
    from audiotokenization_tpu_torch.ops.cuda.vq_kernel import vq_argmin_plain

    for m in (jstft, jgan, jfvq):
        mp.setattr(m, "jnp", _Float32IsFloat64())
    hann, mel = jstft.hann_window, jstft.mel_filterbank
    for m in (jstft, jmel):
        mp.setattr(m, "hann_window", lambda *a, **k: hann(*a, **{**k, "dtype": jnp.float64}))
        mp.setattr(m, "mel_filterbank", lambda *a, **k: mel(*a, **{**k, "dtype": jnp.float64}))
    mp.setattr(jvq, "vq_argmin", _plain_argmin64)
    to_float = torch.Tensor.float
    mp.setattr(torch.Tensor, "float", lambda self, *a, **k: (
        self if self.dtype == torch.float64 else to_float(self, *a, **k)))
    thann, tmelfb = tstft.hann_window, tstft.mel_filterbank
    mp.setattr(tstft, "hann_window", lambda *a, **k: thann(*a, **k).double())
    mp.setattr(tmel, "mel_filterbank", lambda **k: tmelfb(**k).astype(np.float64))
    mp.setattr(tfvq, "vq_argmin", vq_argmin_plain)


@pytest.fixture(scope="module")
def lifted_steps():
    """(JAX, port) per step in float64 with every island lifted, from port seed 0."""
    jcfg = smooth(tiny())
    cfg, port, jstate = states(jcfg, 0)
    wavs = [w.astype(np.float64) for w in batches(seed=1)]
    with pytest.MonkeyPatch.context() as mp:
        _lift_islands(mp)
        with jax.enable_x64(True):
            jax_out = _jax_steps(jax.jit(jax_make_train_step(jcfg)),
                                 _f64_state(jstate, jcfg, quantizer_f64=True), wavs)
        state = train_state(cfg, port.gen.double(), port.disc.double())
        port_out = _port_steps(cfg, state, wavs, torch.float64)
    return jax_out, port_out


@pytest.mark.parametrize("k", range(N_STEPS))
def test_lifted_float64_updates_match_jax_within_1e3(lifted_steps, k):
    """Port seed 0 with the float32 islands lifted on both sides: the
    updates agree within 1e-3 (module docstring)."""
    (jm, jb, ja), (pm, pb, pa) = lifted_steps[0][k], lifted_steps[1][k]
    assert pa["gen.quantizer.layers.0.codebook"].dtype == np.float64
    assert pa.keys() == ja.keys()
    np.testing.assert_allclose(float(pm["gen_loss"]), float(jm["gen_loss"]), rtol=1e-6)
    for name in ja:
        hold_update(name, (pb[name], pa[name]), (jb[name], ja[name]), UPDATE_ATOL)


@pytest.fixture(scope="module")
def port_init_draws(jax_step64):
    """seed -> per step ((JAX fp32), (JAX float64, islands pinned), (port
    fp32)), each (metrics, leaves before, leaves after), from the port's
    initial weights; each JAX step is compiled once for both seeds."""
    jcfg = smooth(tiny())
    wavs = batches(seed=1)
    step32 = jax.jit(jax_make_train_step(jcfg))
    out = {}
    for seed in (0, 1):
        cfg, port, jstate = states(jcfg, seed)
        j32 = _jax_steps(step32, jstate, wavs)
        with jax.enable_x64(True):
            j64 = _jax_steps(jax_step64, _f64_state(jstate, jcfg, quantizer_f64=False),
                             [w.astype(np.float64) for w in wavs])
        out[seed] = list(zip(j32, j64, _port_steps(cfg, port, wavs)))
    return out


def _worst_rel(side, ref):
    """The worst leaf's max |update - reference update| less twice the
    parameters' float32 spacing, over the reference's max |update|."""
    (_, before, after), (_, rb, ra) = side, ref
    worst = 0.0
    for name in ra:
        want = ra[name] - rb[name]
        scale = float(np.abs(want).max())
        if scale == 0:
            continue
        ulp = 2 * np.spacing(np.maximum(np.abs(rb[name]), np.abs(ra[name])).astype(np.float32))
        err = np.maximum(np.abs((after[name] - before[name]) - want) - ulp, 0.0)
        worst = max(worst, float(err.max()) / scale)
    return worst


@pytest.mark.parametrize("k", range(N_STEPS))
@pytest.mark.parametrize("seed", [0, 1])
def test_port_init_fp32_updates_within_2x_jax_fp32_error(port_init_draws, seed, k):
    j32, j64, p32 = port_init_draws[seed][k]
    port_err, jax_err = _worst_rel(p32, j64), _worst_rel(j32, j64)
    assert jax_err > 0
    assert port_err <= FP32_RATIO * jax_err, (
        f"seed {seed} step {k}: the port's fp32 update is {port_err:.3g} x max |update| off "
        f"JAX's float64 step, JAX's own fp32 step {jax_err:.3g}")
