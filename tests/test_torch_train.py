"""The port's GAN training step against the JAX package's, on the tiny
config of tests/test_train_step.py, from the same weights
(convert.train_state_from_jax); its semantics (the generator sees the updated
discriminator, gradient accumulation, the non-finite guard, bf16); K2's
autograd Function; K1 under autograd; the entry points.

Tolerances, stated per check: metrics rtol 1e-4 / atol 1e-6 (fp32);
parameter updates rtol 1e-3 / atol 1e-3 x the leaf's max |update|, with
AdamW's eps = 1 and no warmup so an update is close to lr·g, not lr·sign(g).
An update is read as (after - before) of fp32 parameters, so each element
also gets twice the spacing of the parameter at its value: torch's AdamW
rounds a parameter twice an update (the decay, then the step), optax once. From step 1 on, atol is 3e-3 x the
leaf's max |update|: a few leaves (the encoder's snake α/β, updates ~1e-9)
carry gradients that are sums with heavy cancellation, and there two runs
of the port itself that differ only in their CPU thread count (the order of
fp32 sums) already move the updates by up to 1.3e-3 x max |update|; the
port and JAX differ by up to 1.5e-3 (the two measured on this test's
inputs). Step 0 holds at 1e-3.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu.models.quantizers import factorized_vq as JQ
from audiotokenization_tpu.train.state import init_train_state as jax_init_train_state
from audiotokenization_tpu.train.step import make_train_step as jax_make_train_step
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.convert import params_from_jax, train_state_from_jax
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.models.quantizers import factorized_vq as TQ
from audiotokenization_tpu_torch.ops.cuda import residual_unit_kernel as K2
from audiotokenization_tpu_torch.ops.cuda import vq_kernel as K1
from audiotokenization_tpu_torch.train.schedule import warmup_lr_schedule
from audiotokenization_tpu_torch.train.state import init_train_state, train_state
from audiotokenization_tpu_torch.train.step import make_train_step

METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-6
UPDATE_RTOL, UPDATE_ATOL = 1e-3, 1e-3
LATER_UPDATE_ATOL = 3e-3  # steps 1 and 2 (module docstring)
N_STEPS = 3
KEYS = ("disc_loss", "real_loss", "fake_loss", "gen_loss", "mel_loss", "adv_loss",
        "fm_loss", "vq_loss", "gen_lr")


def smooth(jcfg):
    """eps = 1 and no warmup on both sides (the update-comparison setting)."""
    jcfg = copy.deepcopy(jcfg)
    t = jcfg.train
    for o in (t.gen_optim_params, t.disc_optim_params):
        o.eps = 1.0
    for s in (t.gen_schedule_params, t.disc_schedule_params):
        s.warmup_step = 0
    return jcfg


def tiny():
    """tests/test_train_step.py's tiny config: fp32."""
    jcfg = GE._tiny_config()
    jcfg.train.precision = "fp32"
    return jcfg


def port_cfg(jcfg):
    return PC.from_dict(dataclasses.asdict(jcfg))


def batches(n=N_STEPS, b=2, t=800, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, t) * 0.1).astype(np.float32) for _ in range(n)]


def leaves(state):
    """name -> numpy of both sides' parameters of a port state."""
    return {**{"gen." + k: v.detach().numpy().copy() for k, v in state.gen.state_dict().items()},
            **{"disc." + k: v.detach().numpy().copy() for k, v in state.disc.state_dict().items()}}


def jax_leaves(state):
    tree = jax.tree.map(np.asarray, state)
    return {**{"gen." + k: v.numpy() for k, v in params_from_jax(tree.gen_params).items()},
            **{"disc." + k: v.numpy() for k, v in params_from_jax(tree.disc_params).items()}}


def run_jax(jcfg, state, wavs):
    step = jax.jit(jax_make_train_step(jcfg))
    out = []
    for w in wavs:
        before = jax_leaves(state)
        state, m = step(state, {"wav": jnp.asarray(w)})
        out.append(({k: np.asarray(v) for k, v in m.items()}, before, jax_leaves(state)))
    return out


def run_port(jcfg, jstate, wavs):
    cfg = port_cfg(jcfg)
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg, device="cpu")
    step = make_train_step(cfg, device="cpu")
    out = []
    for w in wavs:
        before = leaves(state)
        m = step(state, {"wav": torch.from_numpy(w)})
        out.append(({k: (v.numpy() if torch.is_tensor(v) else np.asarray(v))
                     for k, v in m.items()}, before, leaves(state)))
    return out


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU steps here are many small ops: one intra-op thread is
    as fast alone and does not oversubscribe the cores that parallel test
    workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_state():
    """The tiny config (fp32) and its JAX train state at step 0."""
    jcfg = tiny()
    return jcfg, jax.jit(lambda k: jax_init_train_state(k, jcfg))(jax.random.key(0))


@pytest.fixture(scope="module")
def three_steps(jax_state):
    jcfg, state = jax_state
    wavs = batches()
    return run_jax(jcfg, state, wavs), run_port(jcfg, state, wavs)


@pytest.fixture(scope="module")
def three_smooth_steps(jax_state):
    jcfg, state = jax_state
    jcfg = smooth(jcfg)
    wavs = batches(seed=1)
    return run_jax(jcfg, state, wavs), run_port(jcfg, state, wavs)


@pytest.mark.parametrize("k", range(N_STEPS))
def test_step_metrics_match_jax(three_steps, k):
    (jm, _, _), (pm, _, _) = three_steps[0][k], three_steps[1][k]
    for key in KEYS:
        np.testing.assert_allclose(pm[key], jm[key], rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=key)
    np.testing.assert_array_equal(pm["codebook_hist"], jm["codebook_hist"])
    assert set(pm) == set(jm)


@pytest.mark.parametrize("k", range(N_STEPS))
def test_step_updates_match_jax(three_smooth_steps, k):
    (jm, jb, ja), (pm, pb, pa) = three_smooth_steps[0][k], three_smooth_steps[1][k]
    for key in KEYS:
        np.testing.assert_allclose(pm[key], jm[key], rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=key)
    assert set(pa) == set(ja)
    atol = UPDATE_ATOL if k == 0 else LATER_UPDATE_ATOL
    for name in ja:
        hold_update(name, (pb[name], pa[name]), (jb[name], ja[name]), atol)


def hold_update(name, port, ref, atol=UPDATE_ATOL):
    """The port's update (after - before) within rtol 1e-3 / atol ``atol`` x
    max |update| of the reference's, plus twice the parameters' fp32 spacing."""
    got, want = port[1] - port[0], ref[1] - ref[0]
    scale = float(np.abs(want).max())
    assert scale > 0, f"{name}: no update"
    ulp = 2 * np.spacing(np.maximum(np.abs(ref[0]), np.abs(ref[1])).astype(np.float32))
    bad = np.abs(got - want) > UPDATE_RTOL * np.abs(want) + atol * scale + ulp
    assert not bad.any(), (f"{name}: {int(bad.sum())} of {bad.size} updates differ, worst "
                           f"{float(np.abs(got - want).max()):.3g} against max |update| {scale:.3g}")


def test_step_counts_and_lr(three_steps):
    (_, jb, _), (pm, pb, _) = three_steps[0][0], three_steps[1][0]
    for name in jb:  # the same weights going in
        np.testing.assert_array_equal(pb[name], jb[name], err_msg=name)
    sched = warmup_lr_schedule()
    assert [float(m["gen_lr"]) for m, _, _ in three_steps[1]] == [sched(k) for k in range(3)]
    assert pm["codebook_hist"].sum() == 2 * 800 // 10


def _tiny_port_state(jcfg, seed=0):
    return init_train_state(port_cfg(jcfg), generator=torch.Generator().manual_seed(seed),
                            device="cpu")


def test_generator_sees_the_updated_discriminator():
    """Mirror of test_train_step_gen_sees_updated_disc: only the discriminator's
    learning rate differs, yet the generator's update does."""
    jcfg = tiny()
    jcfg2 = copy.deepcopy(jcfg)
    jcfg2.train.disc_schedule_params.max_lr = 0.5
    jcfg2.train.disc_schedule_params.warmup_step = 0
    a = _tiny_port_state(jcfg, seed=1)
    b = train_state(port_cfg(jcfg2), copy.deepcopy(a.gen), copy.deepcopy(a.disc))
    w = torch.from_numpy(batches(1, seed=1)[0])
    make_train_step(port_cfg(jcfg), device="cpu")(a, {"wav": w})
    make_train_step(port_cfg(jcfg2), device="cpu")(b, {"wav": w})
    assert any(not torch.equal(p, q) for p, q in zip(a.gen.parameters(), b.gen.parameters()))


def test_accumulation_matches_the_fused_batch():
    """accumulate_grad_batches = 2 over a batch of 4 equals one step on the 4
    at once, to fp32 rounding: the tolerances of the JAX package's
    test_train_step_accumulation_matches_fused (metrics rtol 2e-4 / atol 1e-6,
    parameters rtol 2e-3 / atol 2e-5), codebook histograms equal."""
    jcfg = tiny()
    acc = copy.deepcopy(jcfg)
    acc.train.accumulate_grad_batches = 2
    fused = _tiny_port_state(jcfg, seed=7)
    accum = train_state(port_cfg(acc), copy.deepcopy(fused.gen), copy.deepcopy(fused.disc))
    w = torch.from_numpy(batches(1, b=4, seed=7)[0])
    mf = make_train_step(port_cfg(jcfg), device="cpu")(fused, {"wav": w})
    ma = make_train_step(port_cfg(acc), device="cpu")(accum, {"wav": w})
    for key in KEYS:
        np.testing.assert_allclose(float(ma[key]), float(mf[key]), rtol=2e-4, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_array_equal(ma["codebook_hist"].numpy(), mf["codebook_hist"].numpy())
    after_f, after_a = leaves(fused), leaves(accum)
    for name in after_f:
        np.testing.assert_allclose(after_a[name], after_f[name], rtol=2e-3, atol=2e-5,
                                   err_msg=name)


def test_guard_nonfinite_keeps_the_parameters_on_a_nan_batch():
    jcfg = tiny()
    jcfg.train.guard_nonfinite = True
    state = _tiny_port_state(jcfg, seed=3)
    step = make_train_step(port_cfg(jcfg), device="cpu")
    before = leaves(state)
    w = batches(1, seed=3)[0]
    w[0, 100] = np.nan
    m = step(state, {"wav": torch.from_numpy(w)})
    assert float(m["nonfinite_skipped"]) == 1.0
    after = leaves(state)
    for name in before:
        np.testing.assert_array_equal(after[name], before[name], err_msg=name)
    assert state.gen_opt.count == state.disc_opt.count == 0 and state.step == 1
    m = step(state, {"wav": torch.from_numpy(batches(1, seed=4)[0])})
    assert float(m["nonfinite_skipped"]) == 0.0
    assert state.gen_opt.count == state.disc_opt.count == 1


def test_bf16_step_keeps_fp32_masters_and_tracks_jax(jax_state):
    """bf16: the masters stay fp32, the quantizer computes in fp32 (its
    commitment loss is fp32, the codes those of its fp32 search), the losses
    are finite and within rtol 5e-2 of the JAX bf16 step from the same weights
    (bf16 rounds in other places in the two packages)."""
    jcfg, state = jax_state
    jcfg = copy.deepcopy(jcfg)
    jcfg.train.precision = "bf16"
    wavs = batches(1, seed=5)
    (jm, _, _), = run_jax(jcfg, state, wavs)
    cfg = port_cfg(jcfg)
    port = train_state_from_jax(jax.tree.map(np.asarray, state), cfg, device="cpu")
    # this build's oneDNN bf16 conv2d is wrong for kernels wider than the padded
    # input (the spectrogram discriminator's 5x5 stage on a width-2 map)
    with torch.backends.mkldnn.flags(enabled=False):
        out = TC.forward(port.gen, {"wav": torch.from_numpy(wavs[0])}, training=True)
        pm = make_train_step(cfg, device="cpu")(port, {"wav": torch.from_numpy(wavs[0])})
    assert out.gen_wav.dtype == torch.bfloat16 and out.vq_loss.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in port.gen.parameters())
    assert all(p.dtype == torch.float32 for p in port.disc.parameters())
    for key in KEYS:
        v = float(pm[key])
        assert np.isfinite(v), key
        np.testing.assert_allclose(v, float(jm[key]), rtol=5e-2, err_msg=key)


def _unit_inputs(B=2, C=3, T=10, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = [(B, C, T), (C, C, 7), (C,), (C, C, 1), (C,), (C,), (C,), (C,), (C,)]
    return [(0.5 * torch.randn(s, generator=g)).to(dtype) for s in shapes]


def _plain_launch(*args, dilation):
    return K2.residual_unit_plain(*args, dilation=dilation)


def test_k2_function_gradcheck_float64():
    """K2's Function with its forward handed in (the plain version, on the
    CPU): its recompute backward passes gradcheck for all nine inputs."""
    inputs = [t.requires_grad_(True) for t in _unit_inputs()]
    assert torch.autograd.gradcheck(
        lambda *ts: K2.ResidualUnitFn.apply(_plain_launch, 2, *ts), inputs)


@pytest.mark.parametrize("grad_x,grad_w", [(True, False), (False, True), (False, False)])
def test_k2_function_output_requires_grad_with_its_inputs(grad_x, grad_w):
    """The CUDA route's output carries a graph exactly when an input does; a
    launch writing into torch.empty_like would give none, and no gradient."""
    x, *ws = _unit_inputs(dtype=torch.float32)
    x.requires_grad_(grad_x)
    ws[0].requires_grad_(grad_w)
    out = K2.ResidualUnitFn.apply(_plain_launch, 3, x, *ws)
    assert out.requires_grad == (grad_x or grad_w)
    if grad_x:
        (g,) = torch.autograd.grad(out.sum(), x)
        assert g.abs().sum() > 0


def test_k2_function_runs_bf16_through_an_fp32_launch():
    seen = []

    def launch(*args, dilation):
        seen.append({t.dtype for t in args})
        return K2.residual_unit_plain(*args, dilation=dilation)

    x, *ws = _unit_inputs(dtype=torch.bfloat16)
    x.requires_grad_(True)
    out = K2.ResidualUnitFn.apply(launch, 1, x, *ws)
    assert seen == [{torch.float32}] and out.dtype == torch.bfloat16
    (g,) = torch.autograd.grad(out.float().sum(), x)
    assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()


def spacing_atol(want):
    """Four fp32 spacings at the leaf's largest gradient, at least 1e-6: the
    weight-norm gradient of ``v`` cancels, so an element far below the leaf's
    scale moves by a spacing or two with the machine's summation order."""
    return max(1e-6, 4 * np.finfo(np.float32).eps * float(np.abs(want).max()))


@pytest.mark.parametrize("route", ["plain", "function"])
def test_k1_wrapper_gradients_match_jax(route, monkeypatch):
    """d/d(input, codebook, projections) of residual_vq_apply(training=True)'s
    commitment loss plus a downstream sum of the quantized latents, against
    jax.grad of the same; "function" routes the search through K1's autograd
    Function (its launch handed the plain version). rtol 1e-4; atol per leaf
    from ``spacing_atol``."""
    if route == "function":
        monkeypatch.setattr(K1, "_launch", K1.vq_argmin_plain)
        monkeypatch.setattr(TQ, "vq_argmin", K1.VQArgminFn.apply)
    rng = np.random.RandomState(7)
    x = (rng.randn(2, 32, 40) * 0.5).astype(np.float32)
    r = rng.randn(2, 32, 40).astype(np.float32)
    q = TQ.ResidualVQ(num_quantizers=1, dim=32, codebook_size=64, codebook_dim=8,
                      generator=torch.Generator().manual_seed(7))
    names = [n for n, _ in q.named_parameters()]
    tree = {"layers": [{k: {n.split(".")[-1]: p.detach().numpy()
                            for n, p in q.named_parameters() if n.startswith(f"layers.0.{k}.")}
                        for k in ("in_proj", "out_proj")}]}
    tree["layers"][0]["codebook"] = q.layers[0].codebook.detach().numpy()

    def jax_loss(params, x):
        zq, _, losses = JQ.residual_vq_apply(params, x, num_quantizers=1, training=True)
        return jnp.sum(losses) + jnp.sum(zq * r)

    jg_p, jg_x = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(jax.tree.map(jnp.asarray, tree),
                                                              jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    zq, idx, losses = TQ.residual_vq_apply(q, xt, num_quantizers=1, training=True)
    assert not idx.requires_grad
    grads = torch.autograd.grad(losses.sum() + (zq * torch.from_numpy(r)).sum(),
                                [xt, *q.parameters()])
    want = {"x": jg_x, **{n: v for n, v in params_from_jax(
        jax.tree.map(np.asarray, {"layers": jg_p["layers"]})).items()}}
    for n, g in zip(["x", *names], grads):
        w = np.asarray(want[n])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=spacing_atol(w), err_msg=n)
    assert float(grads[names.index("layers.0.codebook") + 1].abs().sum()) > 0


def test_entry_points_default_to_cuda_and_raise_without_a_card(jax_state):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    jcfg, state = jax_state
    cfg = port_cfg(jcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_state_from_jax(jax.tree.map(np.asarray, state), cfg)


@pytest.mark.parametrize("change", ["ema_vq", "semantic", "lfq"])
def test_unported_training_configurations_raise(change):
    """The semantic branch, the EMA VQ and LFQ (8 bits) build a step (the
    semantic one runs with a teacher or targets: tests/test_torch_semantic_train.py),
    and the library quantizers no codec selects (SimVQ, the random
    projection) raise JAX's ValueError in their place."""
    cfg = port_cfg(tiny())
    if change == "semantic":
        cfg.train.use_semantic = True
        assert callable(make_train_step(cfg, device="cpu"))
        cfg.model.codec_decoder.quantizer = "sim_vq"
        with pytest.raises(ValueError, match="unknown quantizer sim_vq"):
            make_train_step(cfg, device="cpu")
        return
    d = cfg.model.codec_decoder
    d.quantizer = change
    if change == "lfq":
        d.in_channels = cfg.model.codec_encoder.out_channels = 8
    assert callable(make_train_step(cfg, device="cpu"))
    d.quantizer = {"ema_vq": "sim_vq", "lfq": "rpq"}[change]
    with pytest.raises(ValueError, match=f"unknown quantizer {d.quantizer}"):
        make_train_step(cfg, device="cpu")
