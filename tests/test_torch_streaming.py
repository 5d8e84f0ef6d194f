"""The port's streaming runtime and chunked tokenizer against the JAX
package's (CPU, tiny causal configs, the same weights in both;
the BigCodec cases of tests/test_streaming.py):

- ``res_lstm_streaming`` over two chunks, with and without a (T,) suffix
  ``valid``, against JAX's within 1e-5;
- ``StreamingTokenizer``, plain and causal + anti-aliased (with
  ``flush``): streamed tokens equal to the port's offline ``tokenize`` and
  to JAX's, token for token; on the 5-stage stack, to the port's;
- ``StreamingSynthesizer`` / ``stream_decode`` (a partial last chunk
  included) and the live round trip: waveforms against JAX's offline
  ``decode`` within rtol 1e-3 / atol 2e-5 (the repo's waveform tolerance);
- non-causal configs raise, and the Conformer's streaming classes a
  non-causal or MoE Conformer;
  ``flush`` is empty without anti-aliasing; the entry points default to
  the card;
- ``tokenize_chunked`` equals JAX's, and the offline tokens away from the
  file's edges;
- ``cli/synthesize.py --streaming`` equals the offline decode of its
  tokens.

The weights are the port's init, the JAX tree built from them
(tests/test_torch_conformer_train.py::jax_tree), and the JAX references
(``tokenize``, ``codes_to_emb`` -> ``decode``) are jitted once per config
and input shape (``jax_ref``): run op by op, each new shape recompiles
every primitive.
"""
import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu.ops import lstm as JL
from audiotokenization_tpu.utils.chunked import receptive_field_samples as jax_rf
from audiotokenization_tpu.utils.chunked import tokenize_chunked as jax_tokenize_chunked
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.cli import synthesize
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.models.streaming import (StreamingConformerSynthesizer,
                                                          StreamingConformerTokenizer,
                                                          StreamingSynthesizer,
                                                          StreamingTokenizer, stream_decode)
from audiotokenization_tpu_torch.ops import lstm as TL
from audiotokenization_tpu_torch.train.checkpoint import CheckpointManager
from audiotokenization_tpu_torch.train.state import init_train_state
from audiotokenization_tpu_torch.utils.chunked import (make_chunked_tokenizer,
                                                       receptive_field_samples,
                                                       tokenize_chunked)

from test_torch_conformer_train import jax_tree

LSTM_TOL = 1e-5
WAV_RTOL, WAV_ATOL = 1e-3, 2e-5
HOP = 10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: parallel test workers share the cores, and idle
    threads of an oversubscribed pool spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny(causal=True, antialias=False, five_stage=False):
    jcfg = GE._tiny_config()
    jcfg.train.precision = "fp32"
    e, d = jcfg.model.codec_encoder, jcfg.model.codec_decoder
    for part in (e, d):
        part.causal, part.antialias = causal, antialias
    if five_stage:  # the flagship's strides (hop 200) at small widths
        e.ngf, e.out_channels, e.up_ratios = 4, 32, (2, 2, 2, 5, 5)
        d.in_channels, d.upsample_initial_channel, d.up_ratios = 32, 64, (5, 5, 2, 2, 2)
    return jcfg


def build(jcfg, seed):
    """The JAX tree and the port's codec holding the same weights (the
    port's init from ``seed``)."""
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    codec = TC.init_codec(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return jax_tree(codec.state_dict()), codec


_JITTED: dict = {}


def jax_ref(fn, jcfg):
    """``fn(params, jcfg, *args)`` jitted once per function and config (the
    config is held, so its id stays its own)."""
    key = (fn, id(jcfg))
    if key not in _JITTED:
        _JITTED[key] = (jcfg, jax.jit(lambda params, *args: fn(params, jcfg, *args)))
    return _JITTED[key][1]


def _decode_codes(params, jcfg, codes):
    return JC.decode(params, jcfg, JC.codes_to_emb(params, jcfg, jnp.moveaxis(codes, 0, -1)))


def jax_tokens(params, jcfg, wav):
    return np.asarray(jax_ref(JC.tokenize, jcfg)(params, jnp.asarray(wav)))


@pytest.fixture(scope="module")
def plain():
    jcfg = tiny()
    return (jcfg, *build(jcfg, 0))


@pytest.fixture(scope="module")
def antialiased():
    jcfg = tiny(antialias=True)
    return (jcfg, *build(jcfg, 20))


def _stream_tokens(codec, wav, chunk):
    tok = StreamingTokenizer(codec, chunk_samples=chunk, device="cpu")
    state = tok.init_state(batch_size=wav.shape[0])
    pieces = []
    for start in range(0, wav.shape[1], chunk):
        codes, state = tok.step(state, wav[:, start:start + chunk])
        pieces.append(codes)
    tail, _ = tok.flush(state)
    out = torch.cat(pieces + [tail], dim=2).numpy()
    return out[:, :, tok.delay_frames:], tok


def _offline_wav(params, jcfg, codes):
    return np.asarray(jax_ref(_decode_codes, jcfg)(params, jnp.asarray(codes)))[:, 0]


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "suffix-valid"])
def test_res_lstm_streaming_matches_jax(masked):
    F, layers = 12, 2
    tree = JL.init_lstm(jax.random.key(3), F, F, num_layers=layers)
    m = TL.init_lstm(F, F, num_layers=layers, generator=torch.Generator().manual_seed(0))
    m.load_state_dict({k.removeprefix("lstm."): v for k, v in params_from_jax(
        {"lstm": jax.tree.map(np.asarray, tree)}).items()})
    x = np.random.RandomState(3).randn(2, F, 9).astype(np.float32)
    chunks = [(x[:, :, :4], np.arange(4) >= (3 if masked else 0)), (x[:, :, 4:], None)]
    jstate, tstate = None, None
    for xc, valid in chunks:
        jv = None if valid is None else jnp.asarray(valid)
        want, jstate = JL.res_lstm_streaming(jnp.asarray(xc), tree, jstate, num_layers=layers,
                                             valid=jv)
        with torch.no_grad():
            got, tstate = TL.res_lstm_streaming(
                torch.from_numpy(xc), m, tstate,
                valid=None if valid is None else torch.from_numpy(valid))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LSTM_TOL)
        for (h, c), (jh, jc) in zip(tstate, jstate):
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=LSTM_TOL)
            np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=LSTM_TOL)
        if valid is not None:  # frames before the stream come out zero, skip included
            assert not got[:, :, :int((~valid).sum())].any()
    with pytest.raises(ValueError, match="suffix"):
        TL.res_lstm_streaming(torch.from_numpy(x), m, None,
                              valid=torch.from_numpy(np.arange(9) % 2 == 0))


def test_streaming_matches_offline_tokens(plain):
    jcfg, params, codec = plain
    wav = (np.random.RandomState(0).randn(2, 1200) * 0.1).astype(np.float32)
    streamed, tok = _stream_tokens(codec, wav, 200)
    assert tok.delay_frames == 0
    np.testing.assert_array_equal(streamed, TC.tokenize(codec, wav).numpy())
    np.testing.assert_array_equal(streamed, jax_tokens(params, jcfg, wav))


def test_streaming_five_stage_config():
    """The flagship's five strides (hop 200) at small widths: the window's
    hop alignment through every stride phase."""
    codec = TC.init_codec(PC.from_dict(dataclasses.asdict(tiny(five_stage=True))),
                          generator=torch.Generator().manual_seed(1), device="cpu")
    wav = (np.random.RandomState(1).randn(1, 2400) * 0.1).astype(np.float32)
    streamed, _ = _stream_tokens(codec, wav, 400)
    assert streamed.shape == (1, 1, 12)
    np.testing.assert_array_equal(streamed, TC.tokenize(codec, wav).numpy())


def test_streaming_tokenizer_antialias_exact(antialiased):
    jcfg, params, codec = antialiased
    wav = (np.random.RandomState(20).randn(1, 2000) * 0.1).astype(np.float32)
    streamed, tok = _stream_tokens(codec, wav, 200)
    assert tok.delay_frames > 0
    np.testing.assert_array_equal(streamed[:, :, :200], TC.tokenize(codec, wav).numpy())
    np.testing.assert_array_equal(streamed[:, :, :200], jax_tokens(params, jcfg, wav))


def test_streaming_synthesizer_matches_offline_decode(plain):
    jcfg, params, codec = plain
    codes = np.random.RandomState(3).randint(0, 64, (1, 2, 120)).astype(np.int32)
    syn = StreamingSynthesizer(codec, chunk_frames=20, device="cpu")
    state = syn.init_state(batch_size=2)
    pieces = []
    for start in range(0, 120, 20):
        wav, state = syn.step(state, codes[:, :, start:start + 20])
        pieces.append(wav)
    streamed = torch.cat(pieces, dim=1).numpy()
    want = _offline_wav(params, jcfg, codes)
    assert streamed.shape == want.shape == (2, 1200)
    np.testing.assert_allclose(streamed, want, rtol=WAV_RTOL, atol=WAV_ATOL)


@pytest.mark.parametrize("which", ["plain", "antialiased"])
def test_stream_decode_partial_chunk(request, which):
    """57 frames in chunks of 20: a last chunk of 17, with the latency and
    flush of the anti-aliased decoder."""
    jcfg, params, codec = request.getfixturevalue(which)
    codes = np.random.RandomState(23).randint(0, 64, (1, 2, 57)).astype(np.int32)
    got = stream_decode(codec, codes, chunk_frames=20, device="cpu").numpy()
    want = _offline_wav(params, jcfg, codes)
    assert got.shape == want.shape == (2, 570)
    np.testing.assert_allclose(got, want, rtol=WAV_RTOL, atol=WAV_ATOL)


def test_streaming_roundtrip_causal(plain):
    """The live loop: wav chunks -> tokens -> wav chunks, equal to the offline
    round trip."""
    jcfg, params, codec = plain
    wav = (np.random.RandomState(4).randn(1, 800) * 0.1).astype(np.float32)
    tok = StreamingTokenizer(codec, chunk_samples=200, device="cpu")
    syn = StreamingSynthesizer(codec, chunk_frames=20, device="cpu")
    ts, ss = tok.init_state(1), syn.init_state(1)
    out = []
    for start in range(0, 800, 200):
        codes, ts = tok.step(ts, wav[:, start:start + 200])
        w, ss = syn.step(ss, codes)
        out.append(w)
    want = _offline_wav(params, jcfg, jax_tokens(params, jcfg, wav))
    np.testing.assert_allclose(torch.cat(out, dim=1).numpy(), want, rtol=WAV_RTOL,
                               atol=WAV_ATOL)


def test_streaming_rejects_noncausal_and_conformer(plain):
    """Non-causal configs raise; the BigCodec classes refuse a Conformer,
    and the Conformer's classes a non-causal Conformer (``ValueError``) and
    its MoE feed-forward (``NotImplementedError``, with JAX's reason)."""
    _, _, codec = plain
    noncausal = TC.init_codec(PC.from_dict(dataclasses.asdict(tiny(causal=False))),
                              generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="causal"):
        StreamingTokenizer(noncausal, chunk_samples=200, device="cpu")
    with pytest.raises(ValueError, match="causal"):
        StreamingSynthesizer(noncausal, chunk_frames=20, device="cpu")
    with pytest.raises(ValueError, match="multiple of hop"):
        StreamingTokenizer(codec, chunk_samples=205, device="cpu")
    cfg = copy.deepcopy(codec.cfg)
    cfg.model.codec_encoder.type = "conformer_stft"
    cfg.model.codec_decoder.type = "conformer_istft"
    conformer = types.SimpleNamespace(cfg=cfg)
    with pytest.raises(ValueError, match="StreamingConformerTokenizer"):
        StreamingTokenizer(conformer, chunk_samples=200, device="cpu")
    with pytest.raises(ValueError, match="StreamingConformerSynthesizer"):
        StreamingSynthesizer(conformer, chunk_frames=20, device="cpu")
    for part in (cfg.model.codec_encoder, cfg.model.codec_decoder):
        part.causal = False
    for make in (lambda: StreamingConformerTokenizer(conformer, chunk_samples=200, device="cpu"),
                 lambda: StreamingConformerSynthesizer(conformer, chunk_frames=20, device="cpu"),
                 lambda: stream_decode(conformer, np.zeros((1, 1, 4)), chunk_frames=2,
                                       device="cpu")):
        with pytest.raises(ValueError, match="causal"):
            make()
    for part in (cfg.model.codec_encoder, cfg.model.codec_decoder):
        part.causal, part.ffn_type = True, "moe"
    for make in (lambda: StreamingConformerTokenizer(conformer, chunk_samples=200, device="cpu"),
                 lambda: stream_decode(conformer, np.zeros((1, 1, 4)), chunk_frames=2,
                                       device="cpu")):
        with pytest.raises(NotImplementedError, match="batch/chunk-global"):
            make()


def test_streaming_flush_noop_without_antialias(plain):
    _, _, codec = plain
    tok = StreamingTokenizer(codec, chunk_samples=100, device="cpu")
    codes, _ = tok.flush(tok.init_state(1))
    assert codes.shape == (1, 1, 0)
    syn = StreamingSynthesizer(codec, chunk_frames=10, device="cpu")
    assert syn.delay_frames == 0
    wav, _ = syn.flush(syn.init_state(1))
    assert wav.shape == (1, 0)


def test_streaming_entry_points_default_to_the_card(plain):
    _, _, codec = plain
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for make in (lambda: StreamingTokenizer(codec, chunk_samples=200),
                 lambda: StreamingSynthesizer(codec, chunk_frames=20),
                 lambda: stream_decode(codec, np.zeros((1, 1, 4), np.int32), chunk_frames=2),
                 lambda: make_chunked_tokenizer(codec)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


@pytest.mark.parametrize("causal", [False, True], ids=["non-causal", "causal"])
def test_tokenize_chunked_equals_offline(causal):
    """Token for token JAX's ``tokenize_chunked``; and the offline tokens at
    every frame but the file's edges: the first ctx / hop frames and the
    last, where the zero context the chunks add beyond the file reaches the
    ResLSTM (its start state) and conv_out, in both packages. The windows'
    seams (frames 80, 160, 240) lie inside."""
    jcfg = tiny(causal=causal)
    params, codec = build(jcfg, 9)
    assert receptive_field_samples(codec.cfg) == jax_rf(jcfg) == 295
    wav = (np.random.RandomState(9).randn(3170) * 0.1).astype(np.float32)
    got = tokenize_chunked(codec, wav, chunk_seconds=0.05, device="cpu").numpy()  # 800 samples
    want = TC.tokenize(codec, wav[None]).numpy()[:, 0]
    assert got.shape == want.shape == (1, 317)
    np.testing.assert_array_equal(got, jax_tokenize_chunked(params, jcfg, wav, chunk_seconds=0.05))
    edge = -(-295 // HOP)
    np.testing.assert_array_equal(got[:, edge:-1], want[:, edge:-1])


def test_synthesize_cli_streaming_equals_offline_decode(plain, tmp_path):
    jcfg, params, codec = plain
    state = init_train_state(codec.cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    state.gen.load_state_dict(codec.state_dict())
    mngr = CheckpointManager(tmp_path / "run", codec.cfg)
    mngr.save(state)
    mngr.wait()
    out = tmp_path / "synth"
    wav = synthesize.main(["--codec_ckpt", str(tmp_path / "run"), "--random", "--seconds",
                           "0.07", "--num_samples", "2", "--streaming", "4", "--out_dir",
                           str(out), "--device", "cpu"])
    tokens = np.load(out / "tokens.npy").astype(np.int32)
    assert tokens.shape == (2, 112) and wav.shape == (2, 1120)
    want = _offline_wav(params, jcfg, tokens[None])
    np.testing.assert_allclose(wav, want, rtol=WAV_RTOL, atol=WAV_ATOL)
    assert (out / "sample_1.wav").exists()
