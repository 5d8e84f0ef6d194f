"""The port's causal and anti-aliased BigCodec against the JAX package's
(CPU, tiny configs, the same weights in both: the port's init and its JAX
tree, tests/test_torch_streaming.py::build; the JAX references jitted once
per config and shape):

- ``ops/alias_free.py`` (the Kaiser-sinc filter, up/down sampling,
  Activation1d) and ``parallel/sp.py``'s ``_replicate_window`` / ``_SPAA``
  against JAX's within 1e-6;
- ``causal_conv1d`` and ``causal_conv_transpose1d`` against JAX's;
- tiny causal, anti-aliased and causal + anti-aliased codecs: ``tokenize``
  token for token, latents within rtol 1e-3 / atol 2e-4, ``decode``
  within rtol 1e-3 / atol 2e-5 (the repo's tolerances); K2 takes no unit
  of theirs, every unit of the plain config;
- ``make_ragged_codec`` / ``make_ragged_tokenizer`` on those configs
  against each file alone: tokens equal, waveforms within rtol 1e-5 /
  atol 1e-6 (as tests/test_ragged_batch.py holds JAX's);
- a reference-layout checkpoint of a causal codec (convs under the causal
  ``.conv.``) through ``load_reference_checkpoint`` tokenizes as JAX's
  conversion of the same state dict does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu import convert as JV
from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu.ops import alias_free as JA
from audiotokenization_tpu.ops import conv as JCONV
from audiotokenization_tpu.ops import snake as JSN
from audiotokenization_tpu.parallel import sp as JSP
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch import convert as TV
from audiotokenization_tpu_torch.models import bigcodec
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.ops import alias_free as TA
from audiotokenization_tpu_torch.ops import conv as TCONV
from audiotokenization_tpu_torch.ops.snake import SnakeBeta
from audiotokenization_tpu_torch.parallel import sp as TSP
from audiotokenization_tpu_torch.utils.ragged import make_ragged_codec, make_ragged_tokenizer

from test_torch_convert import reference_state_dict, write_reference_run
from test_torch_streaming import build, jax_ref, jax_tokens

AA_TOL = 1e-6
LAT_RTOL, LAT_ATOL = 1e-3, 2e-4
WAV_RTOL, WAV_ATOL = 1e-3, 2e-5
RAGGED_RTOL, RAGGED_ATOL = 1e-5, 1e-6
HOP = 10
VARIANTS = {"causal": (True, False), "antialias": (False, True), "causal+antialias": (True, True)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: parallel test workers share the cores, and idle
    threads of an oversubscribed pool spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def variant_config(causal: bool, antialias: bool):
    jcfg = GE._tiny_config()
    jcfg.train.precision = "fp32"
    for part in (jcfg.model.codec_encoder, jcfg.model.codec_decoder):
        part.causal, part.antialias = causal, antialias
    return jcfg


def _snake(C, seed):
    rng = np.random.RandomState(seed)
    alpha, beta = (rng.randn(C) * 0.3).astype(np.float32), (rng.randn(C) * 0.3).astype(np.float32)
    s = SnakeBeta(C)
    with torch.no_grad():
        s.alpha.copy_(torch.from_numpy(alpha))
        s.beta.copy_(torch.from_numpy(beta))
    return {"alpha": jnp.asarray(alpha), "beta": jnp.asarray(beta)}, s


def test_resample_filter_matches_jax():
    for ratio in (2, 3):
        np.testing.assert_allclose(TA.make_resample_filters(ratio).numpy(),
                                   np.asarray(JA.make_resample_filters(ratio)), rtol=0, atol=AA_TOL)
    np.testing.assert_allclose(TA.kaiser_sinc_filter1d(0.2, 0.3, 11).numpy(),
                               np.asarray(JA.kaiser_sinc_filter1d(0.2, 0.3, 11)),
                               rtol=0, atol=AA_TOL)


def test_resampling_and_activation1d_match_jax():
    x = np.random.RandomState(0).randn(2, 5, 37).astype(np.float32)
    jf, tf = JA.make_resample_filters(2), TA.make_resample_filters(2)
    xt = torch.from_numpy(x)
    for got, want in ((TA.upsample1d(xt, tf), JA.upsample1d(jnp.asarray(x), jf)),
                      (TA.downsample1d(xt, tf), JA.downsample1d(jnp.asarray(x), jf)),
                      (TA.lowpass1d(xt, tf), JA.lowpass1d(jnp.asarray(x), jf))):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=AA_TOL)
    jp, snake = _snake(5, 1)
    with torch.no_grad():
        got = bigcodec._AA(True)(xt, snake).numpy()
    want = JA.activation1d(jnp.asarray(x), lambda y: JSN.snake_beta(y, jp["alpha"], jp["beta"]),
                           antialias=True, up_filter=jf, down_filter=jf)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=AA_TOL)


@pytest.mark.parametrize("g0,bound", [(-5, 30), (0, 30), (7, 20), (12, 15), (-40, 10), (50, 40)])
def test_true_edge_window_matches_jax(g0, bound):
    x = np.random.RandomState(2).randn(2, 4, 24).astype(np.float32)
    np.testing.assert_array_equal(TSP._replicate_window(torch.from_numpy(x), g0, bound).numpy(),
                                  np.asarray(JSP._replicate_window(jnp.asarray(x), g0, bound)))
    jp, snake = _snake(4, 3)
    with torch.no_grad():
        got = TSP._SPAA(True, g0, bound)(torch.from_numpy(x), snake).numpy()
    want = JSP._SPAA(True, g0, bound)(jnp.asarray(x), jp)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=AA_TOL)


@pytest.mark.parametrize("stride,dilation", [(1, 1), (1, 3), (2, 1), (5, 1)])
def test_causal_convs_match_jax(stride, dilation):
    rng = np.random.RandomState(stride * 10 + dilation)
    x = rng.randn(2, 6, 40).astype(np.float32)
    k = 2 * stride if stride > 1 else 7
    w, b = rng.randn(8, 6, k).astype(np.float32) * 0.2, rng.randn(8).astype(np.float32)
    got = TCONV.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                              stride=stride, dilation=dilation)
    want = JCONV.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                               dilation=dilation)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if stride > 1:
        wt = rng.randn(6, 8, 2 * stride).astype(np.float32) * 0.2
        got = TCONV.causal_conv_transpose1d(torch.from_numpy(x), torch.from_numpy(wt),
                                            torch.from_numpy(b), stride=stride)
        want = JCONV.causal_conv_transpose1d(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                                             stride=stride)
        assert got.shape == want.shape == (2, 8, 40 * stride)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=list(VARIANTS), ids=list(VARIANTS))
def variant(request):
    """A tiny variant config, the port's codec at its init and the JAX tree
    of the same weights (tests/test_torch_streaming.py::build)."""
    jcfg = variant_config(*VARIANTS[request.param])
    params, codec = build(jcfg, 5)
    return jcfg, params, codec.cfg, codec


def _decode(params, jcfg, codes):
    return JC.decode(params, jcfg, JC.codes_to_emb(params, jcfg, codes))


def test_variant_tokenize_and_decode_match_jax(variant):
    jcfg, params, cfg, codec = variant
    wav = (np.random.RandomState(6).randn(2, 1230) * 0.1).astype(np.float32)
    want = jax_tokens(params, jcfg, wav)
    got = TC.tokenize(codec, wav)
    assert got.shape == want.shape == (1, 2, 123)
    np.testing.assert_array_equal(got.numpy(), want)
    with torch.no_grad(), TC.full_fp32():
        lat = TC.encode(codec, torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(lat, np.asarray(jax_ref(JC.encode, jcfg)(params, jnp.asarray(wav))),
                               rtol=LAT_RTOL, atol=LAT_ATOL)
    c = want.transpose(1, 2, 0).copy()
    ref = np.asarray(jax_ref(_decode, jcfg)(params, jnp.asarray(c)))
    with torch.no_grad(), TC.full_fp32():
        wav_got = TC.decode(codec, TC.codes_to_emb(codec, torch.from_numpy(c))).numpy()
    assert wav_got.shape == ref.shape == (2, 1, 1230)
    np.testing.assert_allclose(wav_got, ref, rtol=WAV_RTOL, atol=WAV_ATOL)


@pytest.mark.parametrize("causal,antialias,launches", [(False, False, 12), (True, False, 0),
                                                       (False, True, 0), (True, True, 0)])
def test_unit_route_is_fixed_by_the_config(monkeypatch, causal, antialias, launches):
    """K2 takes a unit if and only if it is neither causal nor anti-aliased:
    the tiny config's 6 + 6 units through tokenize and decode."""
    cfg = PC.from_dict(dataclasses.asdict(variant_config(causal, antialias)))
    codec = TC.init_codec(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    calls = []
    real = bigcodec.fused_residual_unit
    monkeypatch.setattr(bigcodec, "fused_residual_unit",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    codes = TC.tokenize(codec, np.zeros((1, 200), np.float32))
    with torch.no_grad():
        TC.decode(codec, TC.codes_to_emb(codec, codes.permute(1, 2, 0)))
    assert len(calls) == launches
    assert all(u.fused == (launches > 0) for part in (codec.encoder, codec.decoder)
               for b in part.blocks for u in b.units)


def test_variant_ragged_paths_match_per_file(variant):
    jcfg, params, cfg, codec = variant
    rng = np.random.RandomState(7)
    lengths = [730, 400, 1000, 90]
    wavs = [(rng.randn(n) * 0.1).astype(np.float32) for n in lengths]
    batch = np.zeros((4, 1000), np.float32)
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = w
    lens = torch.tensor(lengths)
    tok = make_ragged_tokenizer(cfg, device="cpu")(codec, torch.from_numpy(batch), lens)
    recon, codes = make_ragged_codec(cfg, device="cpu")(codec, torch.from_numpy(batch), lens)
    for i, w in enumerate(wavs):
        n = len(w) // HOP
        own = TC.tokenize(codec, w[None]).numpy()[:, 0]
        np.testing.assert_array_equal(tok[:, i, :n].numpy(), own)
        with torch.no_grad():
            out = TC.forward(codec, {"wav": torch.from_numpy(w)[None]})
        np.testing.assert_array_equal(codes[:, i, :n].numpy(), out.vq_code[:, 0].numpy())
        np.testing.assert_allclose(recon[i, :len(w)].numpy(), out.gen_wav[0, 0].numpy(),
                                   rtol=RAGGED_RTOL, atol=RAGGED_ATOL)


def test_causal_reference_checkpoint_tokenizes_as_jax(tmp_path):
    """A reference run dir of a causal codec, every conv under the causal
    ``.conv.``: the port's loader needs no code of its own for it."""
    jcfg = variant_config(True, False)
    tree = jax.tree.map(np.asarray, build(jcfg, 8)[0])
    run = write_reference_run(tmp_path / "ref", tree, jcfg, nested=True)
    cfg, codec = TV.load_reference_checkpoint(run, device="cpu")
    assert cfg.model.codec_encoder.causal and cfg.model.codec_decoder.causal
    sd = reference_state_dict(tree, jcfg, nested=True)
    assert any(".conv.weight_v" in k for k in sd)
    jax_tree = JV.convert_codec_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg)
    wav = (np.random.RandomState(8).randn(2, 800) * 0.1).astype(np.float32)
    want = jax_tokens(jax_tree, jcfg, wav)
    np.testing.assert_array_equal(TC.tokenize(codec, wav).numpy(), want)
