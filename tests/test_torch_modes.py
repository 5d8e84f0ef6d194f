"""The port's tokenize modes (conformant, high, balanced, fast) against the
JAX package's on the tiny config (CPU, same weights from params_from_jax,
same seeded input):

- ``tokenize(mode=...)`` and ``make_ragged_tokenizer(mode=...)`` on 3 files
  of unequal length against JAX's: conformant and high (the CPU has no
  TF32) token for token; balanced and fast the pre-VQ latents within
  5e-2 x max |latent| and the tokens equal on at least 95% of the frames;
- ``cli/extract_indices.py --mode fast`` writes the tokens of the ragged
  tokenizer in fast mode on the model it loads;
- unknown modes raise ``ValueError``.

The bf16 modes run with oneDNN off: this CPU build's oneDNN bf16
convolution is wrong where the kernel is wider than the padded input."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu.utils.ragged import make_ragged_tokenizer as jax_ragged_tokenizer
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.cli import extract_indices
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.data.audio_io import read_audio, write_wav
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.train.checkpoint import CheckpointManager
from audiotokenization_tpu_torch.train.state import init_train_state
from audiotokenization_tpu_torch.utils.ragged import make_ragged_tokenizer

from test_torch_convert import tiny
from test_torch_extract import spread_codes

LAT_REL = 5e-2     # bf16 modes: max |dlatent| <= 5e-2 x max |latent|
AGREE = 0.95       # bf16 modes: tokens equal on at least 95% of the frames
EXACT = ("conformant", "high")
HOP = 10
LENGTHS = [730, 400, 1000]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: parallel test workers share the cores, and idle
    threads of an oversubscribed pool spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def tiny_codec():
    """JAX tiny weights (biases that put every frame on one code zeroed),
    the port's codec with them, and a seeded batch."""
    jcfg = tiny()
    params = spread_codes(jax.tree.map(np.asarray, JC.init_codec(jax.random.key(11), jcfg)))
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    codec = TC.init_codec(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    codec.load_state_dict(params_from_jax(params))
    wav = (np.random.RandomState(11).randn(3, 1600) * 0.3).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, params), cfg, codec, wav


def _jax_latents(params, jcfg, wav, mode):
    """JAX's pre-VQ latents in ``mode``, as its tokenize computes them."""
    x = jnp.asarray(wav)
    if mode == "fast":
        enc16 = {**params, "encoder": JC._cast_tree(params["encoder"], jnp.bfloat16)}
        return np.asarray(JC.encode(enc16, jcfg, x.astype(jnp.bfloat16)).astype(jnp.float32))
    if mode == "balanced":
        return np.asarray(JC._encode_bigcodec_mixed(params, jcfg, x))
    return np.asarray(JC.encode(params, jcfg, x))


def _port_latents(codec, wav, mode):
    enc = codec.encoder
    return TC.encode_in_mode(enc, torch.from_numpy(wav)[:, None, :], mode).numpy()


def _hold_tokens(got, want, mode):
    assert got.shape == want.shape
    if mode in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        assert (got == want).mean() >= AGREE, f"{mode}: {(got != want).sum()} of {got.size} differ"


@pytest.mark.parametrize("mode", TC.MODES)
def test_tokenize_mode_matches_jax(tiny_codec, mode):
    jcfg, params, cfg, codec, wav = tiny_codec
    want = np.asarray(JC.tokenize(params, jcfg, jnp.asarray(wav), mode=mode))
    got = TC.tokenize(codec, wav, mode=mode)
    assert got.dtype == torch.int32 and got.shape == (1, 3, 160)
    assert len(np.unique(want)) > 4  # the comparison is not one code against itself
    _hold_tokens(got.numpy(), want, mode)
    lat = _port_latents(codec, wav, mode)
    lat_ref = _jax_latents(params, jcfg, wav, mode)
    scale = np.abs(lat_ref).max()
    if mode in EXACT:
        np.testing.assert_allclose(lat, lat_ref, rtol=1e-3, atol=2e-4)
    else:
        assert np.abs(lat - lat_ref).max() <= LAT_REL * scale
        # and the mode is not conformant under another name
        assert not np.array_equal(lat, _port_latents(codec, wav, "conformant"))


@pytest.mark.parametrize("mode", TC.MODES)
def test_ragged_tokenizer_mode_matches_jax(tiny_codec, mode):
    jcfg, params, cfg, codec, wav = tiny_codec
    rng = np.random.RandomState(12)
    batch = np.zeros((3, 1000), np.float32)
    for i, n in enumerate(LENGTHS):
        batch[i, :n] = rng.randn(n) * 0.3
    lens = np.asarray(LENGTHS, np.int32)
    want = np.asarray(jax_ragged_tokenizer(jcfg, mode=mode)(params, jnp.asarray(batch),
                                                             jnp.asarray(lens)))
    got = make_ragged_tokenizer(cfg, mode=mode, device="cpu")(
        codec, torch.from_numpy(batch), torch.from_numpy(lens)).numpy()
    assert got.shape == want.shape == (1, 3, 100)
    for i, n in enumerate(LENGTHS):
        _hold_tokens(got[:, i, :n // HOP], want[:, i, :n // HOP], mode)
        if mode in EXACT:  # and each row is its own file's tokenize
            own = TC.tokenize(codec, batch[i:i + 1, :n], mode=mode).numpy()[:, 0]
            np.testing.assert_array_equal(got[:, i, :n // HOP], own)


def test_unknown_modes_raise(tiny_codec):
    _, _, cfg, codec, wav = tiny_codec
    with pytest.raises(ValueError, match="unknown tokenize mode"):
        TC.tokenize(codec, wav, mode="bogus")
    with pytest.raises(ValueError, match="unknown tokenize mode"):
        make_ragged_tokenizer(cfg, mode="highest", device="cpu")
    with pytest.raises(SystemExit):  # argparse's choices
        extract_indices.build_argparser().parse_args(
            ["--save_path", "x", "--subsets", "a", "--mode", "bf16"])


def test_extract_cli_fast_mode_writes_the_ragged_tokenizers_tokens(tiny_codec, tmp_path):
    jcfg, params, cfg, codec, _ = tiny_codec
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    state.gen.load_state_dict(codec.state_dict())
    mngr = CheckpointManager(tmp_path / "run", cfg)
    mngr.save(state)
    mngr.wait()
    rng = np.random.RandomState(13)
    files = []
    for utt, n in enumerate((9731, 12000, 15555)):  # one 1 s bucket, lengths off the hop
        path = tmp_path / "data/LibriSpeech/test-clean/19/198" / f"19-198-{utt:04d}.wav"
        path.parent.mkdir(parents=True, exist_ok=True)
        write_wav(path, (rng.randn(n) * 0.2).astype(np.float32), 16000)
        files.append(path)
    summary = extract_indices.main([
        "--dataset_root", str(tmp_path / "data"), "--save_path", str(tmp_path / "run"),
        "--dataset_path", "LibriSpeech", "--ext_audio", ".wav", "--subsets", "test-clean",
        "--batch_size", "3", "--mode", "fast", "--device", "cpu"])
    assert summary["saved"] == 3 and summary["device_batches"] == 1
    batch = np.zeros((3, 16000), np.float32)
    lens = []
    for i, path in enumerate(files):
        w = read_audio(path)[0][0]
        w = np.pad(w, (0, -len(w) % HOP))
        batch[i, :len(w)] = w
        lens.append(len(w))
    folded = extract_indices.load_model(tmp_path / "run", device="cpu")[1]  # as the CLI loads it
    want = make_ragged_tokenizer(cfg, mode="fast", device="cpu")(
        folded, torch.from_numpy(batch), torch.tensor(lens)).numpy()
    for i, path in enumerate(files):
        got = np.load(tmp_path / "run" / "extracted_indices" / "test-clean" / "19" / "198"
                      / f"{path.stem}.npy")
        assert got.dtype == np.int16 and got.shape == (lens[i] // HOP,)
        np.testing.assert_array_equal(got, want[0, i, :lens[i] // HOP])
