"""The port's training step on the causal and the causal + anti-aliased
BigCodec against the JAX package's ``train/step.py::make_train_step``, from
the same weights: the tiny codecs of ``tests/test_torch_causal.py::
variant_config`` (fp32), whose units run on causal convs and
``ops/alias_free.py`` instead of K2.

One step each, with tests/test_torch_train.py's update setting (AdamW eps 1
and no warmup, so an update is close to lr·g), from JAX's init (one jitted
init, whose tree the anti-aliased variant shares):

- every metric within rtol 1e-4 / atol 1e-6 of JAX's fp32 step, the
  codebook histograms equal;
- in float64 with every float32 island lifted on both sides
  (``test_torch_train64.py::_lift_islands``: the quantizer, the VQ's
  distance, the STFTs, the GAN losses' sums), the port's update within
  ``hold_update``'s 1e-3 x max |update| of JAX's at every leaf: the two
  steps compute one function;
- in fp32, every leaf within ``hold_update``'s 1e-3 of JAX's fp32 step but
  the encoder's snake α/β and the conv biases of its first block's units
  (``ROUNDING_LEAVES``). Their updates are ~1e-10-1e-7, sums with heavy
  cancellation, and float32 rounding alone moves JAX's own fp32 step up to
  6.7e-3 x max |update| off its float64 step. Each of them is held by the
  precision rule against JAX's float64 step: its error no more than 2x
  the worst error of JAX's own fp32 step over those leaves (each less
  twice the parameters' fp32 spacing, over max |update|). The reference
  and the scale are both JAX's, so a fault of the port's arithmetic
  cannot widen its own bound. Per leaf, two fp32 roundings of these sums
  differ by up to about 4x either way (ROADMAP Queue 3).

The tests print what they measure (``pytest -s``).
"""
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.train.state import init_train_state as jax_init_train_state
from audiotokenization_tpu.train.step import make_train_step as jax_make_train_step
from audiotokenization_tpu_torch.convert import train_state_from_jax
from audiotokenization_tpu_torch.train.state import train_state

from test_torch_causal import variant_config
from test_torch_train import (KEYS, METRIC_ATOL, METRIC_RTOL, UPDATE_ATOL, batches, hold_update,
                              jax_leaves, port_cfg, run_port, smooth)
from test_torch_train64 import _f64_state, _lift_islands, _port_steps, _worst_rel

VARIANTS = {"causal": (True, False), "causal+antialias": (True, True)}
ROUNDING_LEAVES = re.compile(r"gen\.encoder\.(.*snake.*\.(alpha|beta)|blocks\.0\.units\.\d\.conv[12]\.b)$")
FP32_RATIO = 2.0  # port fp32 vs JAX float64, over JAX fp32 vs JAX float64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def steps():
    """variant -> (JAX fp32, port fp32, JAX float64, port float64), the
    float64 steps with the islands lifted, each (metrics, leaves before,
    leaves after), one step on one batch from JAX's init. The JAX init and
    steps are lowered from abstract states and compiled in threads while
    the next is traced and the port's steps run, the slowest to compile
    (float64, anti-aliased) first."""
    cfgs = {v: smooth(variant_config(*VARIANTS[v])) for v in VARIANTS}
    order = list(VARIANTS)[::-1]
    wav = batches(1, seed=6)[0]
    pool = ThreadPoolExecutor(1 + 2 * len(VARIANTS))
    # anti-aliasing adds no parameter: one init holds both variants' weights
    key = jax.random.key(0)
    init = jax.jit(lambda k: jax_init_train_state(k, cfgs["causal"])).trace(key)
    init_exe, abstract = pool.submit(lambda: init.lower().compile()), init.out_info
    exe64 = {}
    with pytest.MonkeyPatch.context() as mp:
        _lift_islands(mp)
        with jax.enable_x64(True):
            batch64 = {"wav": jnp.asarray(wav.astype(np.float64))}
            for v in order:
                abstract64 = jax.eval_shape(
                    lambda s, v=v: _f64_state(s, cfgs[v], quantizer_f64=True), abstract)
                exe64[v] = pool.submit(jax.jit(jax_make_train_step(cfgs[v]))
                                       .lower(abstract64, batch64).compile)
    batch = {"wav": jnp.asarray(wav)}
    exe32 = {v: pool.submit(jax.jit(jax_make_train_step(cfgs[v])).lower(abstract, batch).compile)
             for v in order}
    state = init_exe.result()(key)
    tree = jax.tree.map(np.asarray, state)
    port64 = {}
    with pytest.MonkeyPatch.context() as mp:
        _lift_islands(mp)
        for v in VARIANTS:
            cfg = port_cfg(cfgs[v])
            start = train_state_from_jax(tree, cfg, device="cpu")
            port64[v] = _port_steps(cfg, train_state(cfg, start.gen.double(), start.disc.double()),
                                    [wav.astype(np.float64)], torch.float64)[0]
    out = {v: [None, run_port(cfgs[v], state, [wav])[0], None, port64[v]] for v in VARIANTS}
    for v in VARIANTS:
        after, m = exe32[v].result()(state, batch)
        out[v][0] = ({k: np.asarray(x) for k, x in m.items()}, jax_leaves(state), jax_leaves(after))
        with jax.enable_x64(True):
            state64 = _f64_state(state, cfgs[v], quantizer_f64=True)
            after, m = exe64[v].result()(state64, batch64)
            out[v][2] = ({k: np.asarray(x) for k, x in m.items()}, jax_leaves(state64),
                         jax_leaves(after))
    pool.shutdown()
    return out


def _only(side, names):
    metrics, before, after = side
    return metrics, {n: before[n] for n in names}, {n: after[n] for n in names}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_step_metrics_match_jax(steps, variant):
    (jm, _, _), (pm, _, _), _, _ = steps[variant]
    assert set(pm) == set(jm)
    for key in KEYS:
        np.testing.assert_allclose(pm[key], jm[key], rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=key)
    np.testing.assert_array_equal(pm["codebook_hist"], jm["codebook_hist"])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_float64_updates_match_jax_within_1e3(steps, variant):
    _, _, (jm, jb, ja), (pm, pb, pa) = steps[variant]
    assert pa.keys() == ja.keys()
    assert pa["gen.quantizer.layers.0.codebook"].dtype == np.float64
    assert ja["gen.quantizer.layers.0.codebook"].dtype == np.float64
    print(f"{variant}: float64, worst leaf {_worst_rel((pm, pb, pa), (jm, jb, ja)):.3g} x "
          "max |update| off JAX's float64 step")
    np.testing.assert_allclose(float(pm["gen_loss"]), float(jm["gen_loss"]), rtol=1e-6)
    for name in ja:
        hold_update(name, (pb[name], pa[name]), (jb[name], ja[name]), UPDATE_ATOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_step_updates_match_jax(steps, variant):
    jax32, port32, jax64, _ = steps[variant]
    assert port32[2].keys() == jax32[2].keys() == jax64[2].keys()
    for name in jax32[1]:  # the same weights going in
        np.testing.assert_array_equal(port32[1][name], jax32[1][name], err_msg=name)
    rounding = [n for n in jax32[2] if ROUNDING_LEAVES.match(n)]
    assert rounding, "no leaf matches ROUNDING_LEAVES"
    for name in jax32[2]:
        if name not in rounding:
            hold_update(name, (port32[1][name], port32[2][name]),
                        (jax32[1][name], jax32[2][name]), UPDATE_ATOL)
    jax_err = _worst_rel(_only(jax32, rounding), _only(jax64, rounding))
    assert jax_err > 0
    worst = 0.0
    for name in rounding:
        err = _worst_rel(_only(port32, [name]), _only(jax64, [name]))
        worst = max(worst, err)
        assert err <= FP32_RATIO * jax_err, (
            f"{name}: the port's fp32 update is {err:.3g} x max |update| off JAX's float64 "
            f"step, JAX's own fp32 step up to {jax_err:.3g} on {len(rounding)} such leaves")
    print(f"{variant}: {len(jax32[2]) - len(rounding)} leaves within hold_update's 1e-3 of "
          f"JAX's fp32 step; {len(rounding)} rounding leaves at most {worst:.3g} x max |update| "
          f"off JAX's float64 step, JAX's own fp32 step {jax_err:.3g} ({worst / jax_err:.3g}x)")
