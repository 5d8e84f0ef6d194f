"""The port's ragged and streaming Conformer against the JAX package's and
its own offline paths (CPU, the tiny Conformer of tests/test_conformer_train.py
with 2 layers a side, JAX weights through params_from_jax; the cases of
tests/test_ragged_conformer.py and tests/test_streaming_conformer.py):

- ``make_ragged_tokenizer`` on 4 files of unequal length (and an empty
  row): each file's tokens equal its own ``tokenize`` and JAX's ragged
  tokens, non-causal and causal;
- ``make_ragged_codec``: tokens equal, waveforms within rtol 1e-3 / atol
  2e-5 of JAX's ragged codec and of the per-file decode;
- ``StreamingConformerTokenizer`` in chunks of 1, 2 and 5 frames: the
  tokens after the warm-up equal the offline tokens (the port's and
  JAX's), every state tensor finite; a state stepped twice raises, and the
  stream goes on from the newest;
- ``StreamingConformerSynthesizer`` and ``stream_decode`` (a partial last
  chunk included) within the waveform tolerance of JAX's offline decode;
- the refusals (non-causal, MoE, the BigCodec classes on a Conformer) and
  the max_seq_len guard;
- ``cli.extract_indices`` on a Conformer run dir whose hop_length (40)
  differs from prod(up_ratios) (200): ceil(len / 40) frames a file, equal
  to JAX's tokenize of the hop-padded file, and ``--mode balanced``
  refused before any file is read; ``cli.synthesize --streaming``;
  the training loop's ragged test pass.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu.utils.ragged import make_ragged_codec as jax_ragged_codec
from audiotokenization_tpu.utils.ragged import make_ragged_tokenizer as jax_ragged_tokenizer
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.cli import extract_indices, synthesize
from audiotokenization_tpu_torch.data.audio_io import write_wav
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.models.streaming import (StreamingConformerSynthesizer,
                                                          StreamingConformerTokenizer,
                                                          StreamingSynthesizer,
                                                          StreamingTokenizer, stream_decode)
from audiotokenization_tpu_torch.train.checkpoint import CheckpointManager
from audiotokenization_tpu_torch.train.loop import run_test
from audiotokenization_tpu_torch.train.state import init_train_state
from audiotokenization_tpu_torch.utils.ragged import make_ragged_codec, make_ragged_tokenizer

from test_torch_conformer import build, port_decode, tiny

WAV_RTOL, WAV_ATOL = 1e-3, 2e-5
HOP = 40
LENGTHS = [7 * HOP, 12 * HOP, 0, 9 * HOP]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: parallel test workers share the cores, and idle
    threads of an oversubscribed pool spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """Per causality: (jcfg, JAX params, the port's codec)."""
    out = {}
    for causal, seed in ((False, 2), (True, 3)):
        jcfg = tiny(causal)
        out[causal] = (jcfg, *build(jcfg, seed))
    return out


def batch(seed, lengths=LENGTHS):
    rs = np.random.RandomState(seed)
    arr = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        arr[i, :n] = rs.randn(n) * 0.1
    return arr, np.asarray(lengths)


def jax_offline_decode(params, jcfg, codes):
    emb = JC.codes_to_emb(params, jcfg, jnp.moveaxis(jnp.asarray(codes), 0, -1))
    with jax.default_matmul_precision("float32"):
        return np.asarray(JC.decode(params, jcfg, emb))[:, 0]


# -- ragged --------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
def test_ragged_tokens_equal_per_file(models, causal):
    jcfg, params, codec = models[causal]
    arr, lens = batch(4 + causal)
    codes = make_ragged_tokenizer(codec.cfg, device="cpu")(codec, torch.from_numpy(arr),
                                                          torch.from_numpy(lens))
    want = np.asarray(jax_ragged_tokenizer(jcfg)(params, jnp.asarray(arr),
                                                 jnp.asarray(lens, jnp.int32)))
    assert codes.shape == want.shape == (1, len(LENGTHS), max(LENGTHS) // HOP)
    for i, n in enumerate(lens):
        f = n // HOP
        np.testing.assert_array_equal(codes[:, i, :f].numpy(), want[:, i, :f], err_msg=str(i))
        if n:
            alone = TC.tokenize(codec, torch.from_numpy(arr[i:i + 1, :n]))
            assert torch.equal(codes[:, i, :f], alone[:, 0]), i


def test_ragged_round_trip(models):
    jcfg, params, codec = models[False]
    arr, lens = batch(6)
    recon, codes = make_ragged_codec(codec.cfg, device="cpu")(codec, torch.from_numpy(arr),
                                                              torch.from_numpy(lens))
    want_recon, want_codes = jax_ragged_codec(jcfg)(params, jnp.asarray(arr),
                                                   jnp.asarray(lens, jnp.int32))
    assert torch.isfinite(recon).all() and recon.shape == arr.shape
    for i, n in enumerate(lens):
        if not n:
            continue
        np.testing.assert_array_equal(codes[:, i, :n // HOP].numpy(),
                                      np.asarray(want_codes)[:, i, :n // HOP])
        np.testing.assert_allclose(recon[i, :n].numpy(), np.asarray(want_recon)[i, :n],
                                   rtol=WAV_RTOL, atol=WAV_ATOL)
        alone = port_decode(codec, codes[:, i:i + 1, :n // HOP].numpy())[0, 0]
        np.testing.assert_allclose(recon[i, :n].numpy(), alone, rtol=WAV_RTOL, atol=WAV_ATOL)


# -- streaming ---------------------------------------------------------------------

def stream_tokens(tok, wav, chunk):
    state = tok.init_state(batch_size=wav.shape[0])
    outs = []
    for s in range(0, wav.shape[1], chunk):
        codes, state = tok.step(state, torch.from_numpy(wav[:, s:s + chunk]))
        outs.append(codes)
    tail, state = tok.flush(state)
    return torch.cat(outs + [tail], dim=2)[:, :, tok.delay_frames:], state


def finite_state(state):
    tensors = [state.sample_tail, *state.conv_carry, *(t for kv in state.kv_cache for t in kv)]
    return all(torch.isfinite(t).all() for t in tensors)


@pytest.fixture(scope="module")
def offline(models):
    """A 2-stream, 20-frame wav and its offline tokens (the port's, equal to JAX's)."""
    jcfg, params, codec = models[True]
    wav = (np.random.RandomState(7).randn(2, 20 * HOP) * 0.1).astype(np.float32)
    codes = TC.tokenize(codec, torch.from_numpy(wav))
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(JC.tokenize(params, jcfg, jnp.asarray(wav))))
    return wav, codes


@pytest.mark.parametrize("chunk_frames", [1, 2, 5])
def test_streaming_tokens_equal_offline(models, offline, chunk_frames):
    _, _, codec = models[True]
    wav, want = offline
    tok = StreamingConformerTokenizer(codec, chunk_samples=chunk_frames * HOP, device="cpu")
    assert tok.delay_frames == 2  # ceil((160 - 60 - 40) / 40): the STFT's lookahead
    got, state = stream_tokens(tok, wav, chunk_frames * HOP)
    assert torch.equal(got, want)
    assert finite_state(state)
    assert state.pos == wav.shape[1] + tok.delay_frames * HOP


def test_stream_states_are_single_use(models, offline):
    """The K/V caches are written in place: stepping a state that was
    already stepped raises instead of reading the later step's rows, and
    the stream goes on from the newest state."""
    _, _, codec = models[True]
    wav, want = offline
    tok = StreamingConformerTokenizer(codec, chunk_samples=4 * HOP, device="cpu")
    first = tok.init_state(2)
    codes, second = tok.step(first, torch.from_numpy(wav[:, :4 * HOP]))
    with pytest.raises(ValueError, match="single-use"):
        tok.step(first, torch.from_numpy(wav[:, :4 * HOP]))
    outs, state = [codes], second
    for s in range(4 * HOP, wav.shape[1], 4 * HOP):
        codes, state = tok.step(state, torch.from_numpy(wav[:, s:s + 4 * HOP]))
        outs.append(codes)
    with pytest.raises(ValueError, match="single-use"):
        tok.flush(second)
    tail, state = tok.flush(state)
    assert torch.equal(torch.cat(outs + [tail], dim=2)[:, :, tok.delay_frames:], want)
    assert finite_state(state)
    syn = StreamingConformerSynthesizer(codec, chunk_frames=2, device="cpu")
    first = syn.init_state(2)
    syn.step(first, want[:, :, :2])
    with pytest.raises(ValueError, match="single-use"):
        syn.step(first, want[:, :, :2])


@pytest.mark.parametrize("chunk_frames", [1, 4])
def test_synthesizer_matches_offline_decode(models, chunk_frames):
    jcfg, params, codec = models[True]
    codes = np.random.RandomState(8).randint(0, 64, (1, 2, 20))
    want = jax_offline_decode(params, jcfg, codes)
    syn = StreamingConformerSynthesizer(codec, chunk_frames=chunk_frames, device="cpu")
    assert syn.delay_samples == 60
    state, outs = syn.init_state(batch_size=2), []
    for s in range(0, 20, chunk_frames):
        wav, state = syn.step(state, torch.from_numpy(codes[:, :, s:s + chunk_frames]))
        outs.append(wav)
    tail, state = syn.flush(state)
    got = torch.cat(outs + [tail], dim=1)[:, syn.delay_samples:].numpy()
    assert got.shape == want.shape == (2, 20 * HOP)
    np.testing.assert_allclose(got, want, rtol=WAV_RTOL, atol=WAV_ATOL)
    assert all(torch.isfinite(t).all() for kv in state.kv_cache for t in kv)


def test_stream_decode_partial_chunks_and_round_trip(models, offline):
    """Tokens streamed in, waveform streamed out, 20 frames in chunks of 6
    (a partial last chunk), against JAX's offline decode of the tokens."""
    jcfg, params, codec = models[True]
    wav, _ = offline
    codes, _ = stream_tokens(StreamingConformerTokenizer(codec, chunk_samples=4 * HOP,
                                                         device="cpu"), wav, 4 * HOP)
    got = stream_decode(codec, codes, chunk_frames=6, device="cpu").numpy()
    want = jax_offline_decode(params, jcfg, codes.numpy())
    assert got.shape == want.shape == (2, 20 * HOP)
    np.testing.assert_allclose(got, want, rtol=WAV_RTOL, atol=WAV_ATOL)


def test_streaming_refusals_and_the_max_seq_len_guard(models):
    _, _, noncausal = models[False]
    with pytest.raises(ValueError, match="causal"):
        StreamingConformerTokenizer(noncausal, chunk_samples=HOP, device="cpu")
    with pytest.raises(ValueError, match="causal"):
        StreamingConformerSynthesizer(noncausal, chunk_frames=2, device="cpu")
    _, _, codec = models[True]
    with pytest.raises(ValueError, match="StreamingConformerTokenizer"):
        StreamingTokenizer(codec, chunk_samples=200, device="cpu")
    with pytest.raises(ValueError, match="StreamingConformerSynthesizer"):
        StreamingSynthesizer(codec, chunk_frames=2, device="cpu")
    with pytest.raises(ValueError, match="multiple of hop"):
        StreamingConformerTokenizer(codec, chunk_samples=HOP + 1, device="cpu")
    moe = PC.from_dict(dataclasses.asdict(tiny(causal=True)))
    moe.model.codec_encoder.ffn_type = moe.model.codec_decoder.ffn_type = "moe"
    fake = types.SimpleNamespace(cfg=moe)
    with pytest.raises(NotImplementedError, match="batch/chunk-global"):
        StreamingConformerTokenizer(fake, chunk_samples=HOP, device="cpu")
    with pytest.raises(NotImplementedError, match="batch/chunk-global"):
        StreamingConformerSynthesizer(fake, chunk_frames=2, device="cpu")
    short = PC.from_dict(dataclasses.asdict(tiny(causal=True)))
    short.model.codec_encoder.max_seq_len = short.model.codec_decoder.max_seq_len = 6
    small = TC.init_codec(short, generator=torch.Generator().manual_seed(0), device="cpu")
    tok = StreamingConformerTokenizer(small, chunk_samples=4 * HOP, device="cpu")
    state = tok.step(tok.init_state(1), torch.zeros(1, 4 * HOP))[1]
    with pytest.raises(ValueError, match="max_seq_len"):
        tok.step(state, torch.zeros(1, 4 * HOP))
    syn = StreamingConformerSynthesizer(small, chunk_frames=4, device="cpu")
    state = syn.step(syn.init_state(1), torch.zeros(1, 1, 4, dtype=torch.long))[1]
    with pytest.raises(ValueError, match="max_seq_len"):
        syn.step(state, torch.zeros(1, 1, 4, dtype=torch.long))


# -- the CLIs and the loop on a Conformer run dir ----------------------------------------

CORPUS = [(19, 198, 0, 1003), (19, 198, 1, 2400), (26, 495, 0, 1777), (26, 495, 1, 3210)]


@pytest.fixture(scope="module")
def conformer_run(models, tmp_path_factory):
    """A port run dir of the causal tiny Conformer with the JAX weights, and
    a LibriSpeech-layout corpus whose lengths are no whole number of hops."""
    jcfg, params, codec = models[True]
    tmp = tmp_path_factory.mktemp("conformer_run")
    state = init_train_state(codec.cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    state.gen.load_state_dict(codec.state_dict())
    mngr = CheckpointManager(tmp / "run", codec.cfg)
    mngr.save(state)
    mngr.wait()
    rs = np.random.RandomState(9)
    files = {}
    for spk, chap, utt, n in CORPUS:
        d = tmp / "data" / "LibriSpeech" / "test-clean" / str(spk) / str(chap)
        d.mkdir(parents=True, exist_ok=True)
        w = (rs.randn(n) * 0.1).astype(np.float32)
        write_wav(d / f"{spk}-{chap}-{utt:04d}.wav", w, 16000)
        files[f"{spk}-{chap}-{utt:04d}"] = (d, w)
    return tmp, files


def test_extract_cli_uses_the_conformer_hop(models, conformer_run):
    """hop_length 40, prod(up_ratios) 200: each file gets ceil(len / 40)
    frames, JAX's tokens of the file zero-padded to whole hops."""
    from audiotokenization_tpu_torch.data.audio_io import read_audio

    jcfg, params, codec = models[True]
    tmp, files = conformer_run
    assert np.prod(codec.cfg.model.codec_encoder.up_ratios) != HOP
    summary = extract_indices.main(
        ["--dataset_root", str(tmp / "data"), "--save_path", str(tmp / "run"),
         "--dataset_path", "LibriSpeech", "--ext_audio", ".wav", "--subsets", "test-clean",
         "--batch_size", "2", "--device", "cpu"])
    assert summary["saved"] == len(CORPUS) and summary["errors"] == 0
    jax_tokenize = jax.jit(lambda p, w: JC.tokenize(p, jcfg, w))  # one compile a length
    for name, (d, _) in files.items():
        spk, chap, _ = name.split("-")
        got = np.load(tmp / "run" / "extracted_indices" / "test-clean" / spk / chap / f"{name}.npy")
        w = read_audio(d / f"{name}.wav")[0][0]  # the file as the CLI reads it (PCM16)
        assert got.dtype == np.int16 and got.shape == (-(-len(w) // HOP),), name
        padded = np.pad(w, (0, -len(w) % HOP))
        want = np.asarray(jax_tokenize(params, padded[None]))[0, 0]
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_extract_cli_refuses_balanced_on_a_conformer(conformer_run, tmp_path):
    tmp, _ = conformer_run
    out = tmp_path / "out"
    with pytest.raises(ValueError, match="no 'balanced' tokenize mode"):
        extract_indices.main(
            ["--dataset_root", str(tmp / "data"), "--save_path", str(tmp / "run"),
             "--dataset_path", "LibriSpeech", "--ext_audio", ".wav", "--subsets", "test-clean",
             "--mode", "balanced", "--output_folder", str(out), "--device", "cpu"])
    assert not any(out.rglob("*.npy"))


def test_synthesize_streaming_on_a_conformer_run(conformer_run, tmp_path):
    tmp, _ = conformer_run
    wav = synthesize.main(["--codec_ckpt", str(tmp / "run"), "--random", "--seconds", "0.5",
                           "--num_samples", "2", "--streaming", "3", "--out_dir",
                           str(tmp_path), "--device", "cpu"])
    tokens = np.load(tmp_path / "tokens.npy")
    assert wav.shape == (2, 8000) and tokens.shape == (2, 8000 // HOP)
    _, codec = extract_indices.load_model(tmp / "run", device="cpu")
    want = synthesize.decode_tokens(codec, torch.from_numpy(tokens.astype(np.int64))).numpy()
    np.testing.assert_allclose(wav, want, rtol=WAV_RTOL, atol=WAV_ATOL)


def test_the_loops_test_pass_runs_on_a_conformer(models, conformer_run):
    _, _, codec = models[True]
    _, files = conformer_run
    loader = [{"wav": torch.from_numpy(w[:len(w) // HOP * HOP])[None]} for _, w in files.values()]
    metrics = run_test(codec.cfg, codec, loader)
    assert np.isfinite(metrics["test_si_snr"]) and np.isfinite(metrics["test_codebook_perplexity"])
