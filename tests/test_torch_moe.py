"""The port's MoE feed-forward (``ops/moe.py``) and the MoE Conformer
against the JAX package's (CPU, seeded numpy inputs, the same weights: the
layer's JAX init through params_from_jax, the codec's the port's init
through tests/test_torch_conformer_train.py::jax_tree):

- ``moe_ffn`` against JAX ``moe_ffn`` at capacity factor E/K (nothing
  dropped), 1.0 and 0.5 (drops), under a uniform router (every
  probability equal: the lower expert index first, as ``jax.lax.top_k``)
  and with a ``token_mask``: outputs within rtol 1e-5 / atol 1e-6; the
  expert inputs (E, C, d) equal element for element to the buffer JAX's
  dispatch einsum builds (so every slot holds the same token, and the same
  (token, choice) pairs are kept); the chosen experts equal; the aux losses
  within rtol 1e-5 (atol 1e-6 for ``dropped_frac``, a difference of ones);
- the capacity-free oracle at full capacity, and against JAX's oracle;
- gradients of sum(out²) + 0.01 · load balance (tests/test_moe.py) to the
  router, the experts and the input within rtol 1e-4 (atol 1e-4 x the
  gradient's max |g|);
- the tiny MoE Conformer (tests/test_moe.py's config, 4 experts, capacity
  factor 2.0 and 1.25): tokens byte for byte against JAX ``tokenize`` in
  the conformant and high modes (fast: latents within 5e-2 x max |latent|,
  95% of the tokens), decode within rtol 1e-3 / atol 2e-5, ``balanced``
  raising, the decoder dense as JAX builds it;
- what stays refused, with JAX's reason: the ragged tokenizer and codec,
  streaming, reference-checkpoint conversion; the extraction and
  evaluation CLIs process such a codec one file at a time;
- ``configs/conformer_moe.yaml`` builds at full width.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu import config as JCF
from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu.ops import moe as JM
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch import convert as TV
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.models import streaming as TSm
from audiotokenization_tpu_torch.ops import moe as TM
from audiotokenization_tpu_torch.utils.ragged import make_ragged_codec, make_ragged_tokenizer

from test_moe import _moe_conformer_config
from test_torch_conformer_train import jax_tree

OUT_RTOL, OUT_ATOL = 1e-5, 1e-6
AUX_RTOL = 1e-5
GRAD_RTOL = 1e-4
LAT_RTOL, LAT_ATOL = 1e-3, 2e-4
WAV_RTOL, WAV_ATOL = 1e-3, 2e-5
LAT_REL, AGREE = 5e-2, 0.95
DIM, E, K = 16, 4, 2
HOP = 40
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: parallel test workers share the cores, and idle
    threads of an oversubscribed pool spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def setup(seed=0, n=6, t=10):
    """JAX params, the port's layer with the same weights, and x (n, t, DIM)."""
    p = JM.init_moe_ffn(jax.random.key(seed), DIM, n_experts=E, ffn_mult=2)
    m = TM.MoEFeedForward(DIM, n_experts=E, ffn_mult=2, generator=torch.Generator().manual_seed(0))
    m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, p)))
    x = (np.random.RandomState(seed).randn(n, t, DIM) * 0.5).astype(np.float32)
    return p, m, x


def jax_moe(x, p, **kw):
    """JAX moe_ffn, and the (E, C, d) expert inputs its dispatch einsum built
    (the first array ``_constrain_experts`` sees; identity outside TP)."""
    seen = []
    orig = JM._constrain_experts
    JM._constrain_experts = lambda a: (seen.append(np.asarray(a)), a)[1]
    try:
        out, aux = JM.moe_ffn(jnp.asarray(x), p, **kw)
    finally:
        JM._constrain_experts = orig
    return np.asarray(out), {k: float(v) for k, v in aux.items()}, seen[0]


def kept_pairs(buf, xt, experts):
    """(N, k) bool: whether token n's choice reached a slot of ``buf``
    (E, C, d), read off which rows of ``buf`` hold which token."""
    rows = {xt[n].tobytes(): n for n in range(len(xt))}
    slots = {(e, rows[r.tobytes()]) for e in range(buf.shape[0]) for r in buf[e]
             if np.any(r != 0)}
    return np.array([[(int(e), n) in slots for e in experts[n]] for n in range(len(xt))])


CASES = {"full_capacity": dict(capacity_factor=E / K),
         "capacity_1.0": dict(capacity_factor=1.0),
         "capacity_0.5": dict(capacity_factor=0.5),
         "uniform_router": dict(capacity_factor=1.0, uniform=True),
         "token_mask": dict(capacity_factor=1.0, mask=True)}


@pytest.mark.parametrize("case", CASES)
def test_moe_ffn_matches_jax(case):
    kw = dict(CASES[case])
    uniform, mask = kw.pop("uniform", False), kw.pop("mask", False)
    p, m, x = setup(1)
    if uniform:  # every probability 1/E exactly: ties everywhere
        p = {**p, "router": {"w": jnp.zeros_like(p["router"]["w"])}}
        with torch.no_grad():
            m.router.w.zero_()
    tmask = None
    if mask:
        tmask = np.ones(x.shape[:2], bool)
        tmask[:, -3:] = False
        tmask[2, :] = False
    want, want_aux, want_buf = jax_moe(x, p, top_k=K, token_mask=None if tmask is None
                                       else jnp.asarray(tmask), **kw)
    tt = None if tmask is None else torch.from_numpy(tmask)
    with torch.no_grad():
        got, aux = TM.moe_ffn(torch.from_numpy(x), m, top_k=K, token_mask=tt, **kw)
        xt = torch.from_numpy(x).reshape(-1, DIM)
        r = TM.route(xt, m.router.w, top_k=K, token_mask=None if tt is None else tt.reshape(-1),
                     **kw)
        buf = TM.dispatch(xt, r)[0].numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=OUT_RTOL, atol=OUT_ATOL)
    np.testing.assert_array_equal(buf, want_buf)
    probs = jax.nn.softmax(jnp.asarray(xt.numpy()) @ p["router"]["w"].T, axis=-1)
    experts = np.asarray(jax.lax.top_k(probs, K)[1])
    np.testing.assert_array_equal(r.experts.numpy(), experts)
    keep = kept_pairs(want_buf, xt.numpy(), experts)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if uniform:
        assert (experts == np.arange(K)).all()
    if case == "full_capacity":
        assert keep.all()
    elif not mask:
        assert not keep.all()  # the case drops
    for k, v in want_aux.items():
        np.testing.assert_allclose(float(aux[k]), v, rtol=AUX_RTOL,
                                   atol=1e-6 if k == "dropped_frac" else 0, err_msg=k)
    if mask:
        assert np.all(got.numpy()[~tmask] == 0)


def test_dense_oracle_at_full_capacity():
    p, m, x = setup(2)
    with torch.no_grad():
        out, aux = TM.moe_ffn(torch.from_numpy(x), m, top_k=K, capacity_factor=E / K)
        ref = TM.moe_ffn_dense_reference(torch.from_numpy(x), m, top_k=K)
    assert float(aux["dropped_frac"]) == 0.0
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=OUT_RTOL, atol=OUT_ATOL)
    want = np.asarray(JM.moe_ffn_dense_reference(jnp.asarray(x), p, top_k=K))
    np.testing.assert_allclose(ref.numpy(), want, rtol=OUT_RTOL, atol=OUT_ATOL)


@pytest.mark.parametrize("capacity_factor", [2.0, 1.0])
def test_gradients_match_jax(capacity_factor):
    p, m, x = setup(4)

    def jloss(p, x):
        out, aux = JM.moe_ffn(x, p, top_k=K, capacity_factor=capacity_factor)
        return jnp.sum(out ** 2) + 0.01 * aux["load_balance_loss"]

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = TM.moe_ffn(xt, m, top_k=K, capacity_factor=capacity_factor)
    (torch.sum(out ** 2) + 0.01 * aux["load_balance_loss"]).backward()
    want = {**params_from_jax(jax.tree.map(np.asarray, jg)), "x": torch.from_numpy(
        np.asarray(jgx))}
    got = {**{n: q.grad for n, q in m.named_parameters()}, "x": xt.grad}
    assert set(got) == set(want) == {"router.w", "w1", "w2", "w3", "x"}
    for name, g in got.items():
        w = want[name].numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=name)


# -- the MoE Conformer -------------------------------------------------------------

def moe_tiny(capacity_factor=2.0):
    """tests/test_moe.py's MoE Conformer (2 layers a side here, 4 experts)."""
    jcfg = _moe_conformer_config()
    for part in (jcfg.model.codec_encoder, jcfg.model.codec_decoder):
        part.n_layers = 2
        part.moe_capacity_factor = capacity_factor
    return jcfg


def build(jcfg, seed=0):
    """The JAX tree and the port's codec holding the same weights (the
    port's init from ``seed``)."""
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    codec = TC.init_codec(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return jax.tree.map(np.asarray, jax_tree(codec.state_dict())), cfg, codec


@pytest.fixture(scope="module")
def moe_models():
    """Per capacity factor: (jcfg, JAX params, the port's codec)."""
    out = {}
    for cf in (2.0, 1.25):
        jcfg = moe_tiny(cf)
        out[cf] = (jcfg, *build(jcfg, seed=3))
    return out


def wav_batch(seed, n=2, frames=30):
    return (np.random.RandomState(seed).randn(n, frames * HOP) * 0.1).astype(np.float32)


def test_moe_codec_builds_the_jax_tree(moe_models):
    jcfg, params, cfg, codec = moe_models[2.0]
    assert TC.uses_moe(cfg) and codec.encoder_moe
    enc = codec.encoder.backbone.layers[0].ffn1
    assert isinstance(enc, TM.MoEFeedForward) and enc.w1.shape == (4, 256, 32)
    assert not any(isinstance(mod, TM.MoEFeedForward) for mod in codec.decoder.modules())
    assert set(codec.state_dict()) == set(params_from_jax(params))


@pytest.mark.parametrize("cf", [2.0, 1.25])
def test_moe_codec_matches_jax(moe_models, cf):
    """Latents, tokens byte for byte, the decode."""
    jcfg, params, cfg, codec = moe_models[cf]
    wav = wav_batch(20)
    with jax.default_matmul_precision("float32"):  # JC.tokenize's conformant mode
        want_lat = JC.encode(params, jcfg, jnp.asarray(wav))
        want_codes = np.asarray(JC.quantize(params, jcfg, want_lat)[1])
    want_lat = np.asarray(want_lat)
    with TC.full_fp32(), torch.no_grad():
        lat = TC.encode(codec, torch.from_numpy(wav)).numpy()
    codes = TC.tokenize(codec, torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(lat, want_lat, rtol=LAT_RTOL, atol=LAT_ATOL)
    assert codes.dtype == np.int32 and codes.shape == (1, 2, 30)
    np.testing.assert_array_equal(codes, want_codes)
    assert len(np.unique(codes)) > 4
    emb = JC.codes_to_emb(params, jcfg, jnp.moveaxis(jnp.asarray(want_codes), 0, -1))
    with jax.default_matmul_precision("float32"):
        want = np.asarray(JC.decode(params, jcfg, emb))
    with TC.full_fp32(), torch.no_grad():
        got = TC.decode(codec, TC.codes_to_emb(
            codec, torch.from_numpy(want_codes).long().permute(1, 2, 0))).numpy()
    np.testing.assert_allclose(got, want, rtol=WAV_RTOL, atol=WAV_ATOL)


def test_moe_codec_forward_aux_matches_jax(moe_models):
    """forward's moe_aux_loss (means over the encoder's 4 MoE layers) against
    JAX's, at the capacity factor that drops."""
    jcfg, params, cfg, codec = moe_models[1.25]
    wav = wav_batch(21)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(JC.forward(params, jcfg, {"wav": jnp.asarray(wav)}).moe_aux_loss)
    strict = PC.from_dict(dataclasses.asdict(jcfg))
    strict.train.precision = "fp32_strict"
    codec.cfg = strict
    try:
        with torch.no_grad():
            got = TC.forward(codec, {"wav": torch.from_numpy(wav)}).moe_aux_loss.numpy()
    finally:
        codec.cfg = cfg
    assert want[2] > 0  # the capacity drops
    np.testing.assert_allclose(got, want, rtol=AUX_RTOL, atol=1e-6)


@pytest.mark.parametrize("mode", ["high", "fast", "balanced"])
def test_moe_tokenize_modes(moe_models, mode):
    jcfg, params, cfg, codec = moe_models[2.0]
    wav = wav_batch(22)
    if mode == "balanced":
        with pytest.raises(ValueError, match="ConformerEncoder has no 'balanced'"):
            TC.tokenize(codec, torch.from_numpy(wav), mode=mode)
        return
    with torch.backends.mkldnn.flags(enabled=False):
        got = TC.tokenize(codec, torch.from_numpy(wav), mode=mode).numpy()
    if mode == "high":  # no TF32 on the CPU
        want = np.asarray(JC.tokenize(params, jcfg, jnp.asarray(wav), mode=mode))
        np.testing.assert_array_equal(got, want)
        return
    # JC.tokenize's fast mode: the bf16 encoder, then the fp32 quantizer
    enc16 = {**params, "encoder": JC._cast_tree(params["encoder"], jnp.bfloat16)}
    want_lat = JC.encode(enc16, jcfg, jnp.asarray(wav, jnp.bfloat16)).astype(jnp.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(JC.quantize(params, jcfg, want_lat)[1])
    want_lat = np.asarray(want_lat)
    with torch.backends.mkldnn.flags(enabled=False):
        lat = TC.encode_in_mode(codec.encoder, torch.from_numpy(wav)[:, None], "fast").numpy()
    assert np.abs(lat - want_lat).max() <= LAT_REL * np.abs(want_lat).max()
    assert (got == want).mean() >= AGREE


# -- what stays refused, and the per-file routes ------------------------------------

def test_moe_refusals_give_jax_reason(moe_models):
    jcfg, params, cfg, codec = moe_models[2.0]
    for make in (make_ragged_tokenizer, make_ragged_codec):
        with pytest.raises(NotImplementedError, match="capacity routing is batch-global"):
            make(cfg, device="cpu")
    causal = PC.from_dict(dataclasses.asdict(jcfg))
    causal.model.codec_encoder.causal = causal.model.codec_decoder.causal = True
    ccodec = TC.init_codec(causal, generator=torch.Generator().manual_seed(0), device="cpu")
    for cls, kw in ((TSm.StreamingConformerTokenizer, {"chunk_samples": 4 * HOP}),
                    (TSm.StreamingConformerSynthesizer, {"chunk_frames": 4})):
        with pytest.raises(NotImplementedError, match="batch/chunk-global"):
            cls(ccodec, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="dense FFNs only"):
        TV.convert_codec_state_dict({}, cfg)


def write_port_run(run, cfg, codec):
    """A generator-only port run dir (scripts/jax_run_to_torch.py's form)."""
    (run / "ckpt" / "0").mkdir(parents=True)
    PC.save_config(cfg, run / "config.json")
    torch.save({"step": 0, "gen": codec.state_dict()}, run / "ckpt" / "0" / "state.pt")
    return run


def test_moe_cli_routes_per_file(moe_models, tmp_path, capsys, monkeypatch):
    """cli.extract_indices at --batch_size 4: one tokenize (one VQ search) a
    file, ceil(len / hop) int16 frames equal to the file's own tokenize.
    cli.inference_full on whole files: one file a batch, with JAX's note."""
    from audiotokenization_tpu_torch.cli import extract_indices, inference_full
    from audiotokenization_tpu_torch.data.audio_io import read_wav, write_wav
    from audiotokenization_tpu_torch.models.quantizers import factorized_vq as fvq

    jcfg, params, cfg, codec = moe_models[1.25]
    run = write_port_run(tmp_path / "run", cfg, codec)
    d = tmp_path / "data" / "LibriSpeech" / "test-clean" / "7" / "8"
    d.mkdir(parents=True)
    rng = np.random.RandomState(23)
    lens = (1210, 1600, 2035)
    for i, n in enumerate(lens):
        write_wav(d / f"7-8-{i:04d}.wav", (rng.randn(n) * 0.1).astype(np.float32), 16000)
    (tmp_path / "test.txt").write_text("".join(f"{d}/7-8-{i:04d}.wav\n" for i in range(3)))
    searches = []
    plain = fvq.vq_argmin
    monkeypatch.setattr(fvq, "vq_argmin", lambda e, c: (searches.append(e.shape[0]), plain(e, c))[1])
    summary = extract_indices.main(["--dataset_root", str(tmp_path / "data"), "--save_path",
                                    str(run), "--dataset_path", "LibriSpeech", "--ext_audio",
                                    ".wav", "--subsets", "test-clean", "--batch_size", "4",
                                    "--device", "cpu"])
    assert summary["saved"] == 3 and summary["device_batches"] == 3
    assert searches == [-(-n // HOP) for n in lens]  # one file per search
    for i, n in enumerate(lens):
        a = np.load(run / "extracted_indices" / "test-clean" / "7" / "8" / f"7-8-{i:04d}.npy")
        assert a.dtype == np.int16 and a.shape == (-(-n // HOP),)
        wav = read_wav(d / f"7-8-{i:04d}.wav")[0][0]
        wav = np.pad(wav, (0, -len(wav) % HOP))
        want = TC.tokenize(codec, torch.from_numpy(wav)[None]).numpy()[0, 0]
        np.testing.assert_array_equal(a, want)
    searches.clear()
    out = inference_full.main(["--save_path", str(run), "--filelist", str(tmp_path / "test.txt"),
                               "--duration", "0", "--batch_size", "4", "--num_examples", "0",
                               "--device", "cpu"])
    assert "ragged full-length batching unavailable" in capsys.readouterr().out
    assert len(searches) == 3
    assert out["frames"] == sum(-(-n // HOP) for n in lens) and np.isfinite(out["si_snr"])


def test_full_width_moe_config_builds():
    jcfg = JCF.load_config(ROOT / "configs" / "conformer_moe.yaml")
    cfg = PC.load_config(ROOT / "configs" / "conformer_moe.yaml")
    assert PC.to_dict(cfg) == dataclasses.asdict(jcfg)
    codec = TC.Codec(cfg, generator=torch.Generator().manual_seed(0))
    ffn = codec.encoder.backbone.layers[0].ffn1
    assert isinstance(ffn, TM.MoEFeedForward)
    assert tuple(ffn.w1.shape) == (8, 768, 256) and tuple(ffn.w2.shape) == (8, 256, 768)
    assert codec.encoder.backbone.moe_args == (2, 1.25)
    moe = sum(p.numel() for n, p in codec.encoder.named_parameters()
              if ".ffn1." in n or ".ffn2." in n)
    assert moe == 12 * (8 * 3 * 768 * 256 + 8 * 256)
