"""The port's ragged path against the JAX package's: the masked LSTM
(one-way and bidirectional, 2 layers) against JAX's ``lstm(valid=...)``
within 1e-5; ``make_ragged_codec`` on the tiny config against JAX's
``make_ragged_codec`` and the port's own per-file ``forward``: codes byte
for byte, reconstructions within rtol 1e-5 / atol 1e-6 (as
tests/test_ragged_batch.py holds JAX's), also with the FSQ quantizer; a
zero-length row is harmless; unported families raise (the MoE Conformer
with JAX's reason)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu.ops import lstm as JL
from audiotokenization_tpu.utils.ragged import make_ragged_codec as jax_make_ragged_codec
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.ops import lstm as TL
from audiotokenization_tpu_torch.utils.ragged import make_ragged_codec, make_ragged_tokenizer

LSTM_TOL = 1e-5
WAV_RTOL, WAV_ATOL = 1e-5, 1e-6
LENGTHS = [730, 400, 1000]  # hop (10) multiples, as tests/test_ragged_batch.py


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: parallel test workers share the cores, and idle
    threads of an oversubscribed pool spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("bidirectional", [False, True], ids=["one-way", "bidirectional"])
def test_masked_lstm_matches_jax(bidirectional):
    F, T, layers = 12, 10, 2
    hid = F // 2 if bidirectional else F
    tree = JL.init_lstm(jax.random.key(3), F, hid, num_layers=layers, bidirectional=bidirectional)
    x = np.random.RandomState(3).randn(4, T, F).astype(np.float32)
    valid = np.arange(T)[None] < np.asarray([7, 10, 0, 3])[:, None]
    want = JL.lstm(jnp.asarray(x), tree, num_layers=layers, bidirectional=bidirectional,
                   valid=jnp.asarray(valid))
    m = TL.init_lstm(F, hid, num_layers=layers, bidirectional=bidirectional,
                     generator=torch.Generator().manual_seed(0))
    m.load_state_dict({k.removeprefix("lstm."): v for k, v in params_from_jax(
        {"lstm": jax.tree.map(np.asarray, tree)}).items()})
    with torch.no_grad():
        got = TL.lstm(torch.from_numpy(x), m, valid=torch.from_numpy(valid))
        res = TL.res_lstm(torch.from_numpy(x).transpose(1, 2), m, valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LSTM_TOL)
    assert not got[2].any() and not got[0, 7:].any()
    want_res = JL.res_lstm(jnp.asarray(x).swapaxes(1, 2), tree, num_layers=layers,
                           bidirectional=bidirectional, valid=jnp.asarray(valid))
    np.testing.assert_allclose(res.numpy(), np.asarray(want_res), rtol=0, atol=LSTM_TOL)


def test_masked_lstm_refuses_a_mask_with_holes():
    m = TL.init_lstm(4, 4, num_layers=2, bidirectional=True,
                     generator=torch.Generator().manual_seed(0))
    valid = torch.tensor([[True, True, False], [False, True, True]])
    with pytest.raises(ValueError, match="prefix"):
        TL.lstm(torch.zeros(2, 3, 4), m, valid=valid)


@pytest.fixture(scope="module")
def tiny_codec():
    """The tiny config (fp32), JAX parameters and the port's codec with them."""
    jcfg = GE._tiny_config()
    jcfg.train.precision = "fp32"
    params = JC.init_codec(jax.random.key(4), jcfg)
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    codec = TC.init_codec(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    codec.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jcfg, params, cfg, codec.train()


def _batch(lengths, L, seed=4):
    rng = np.random.RandomState(seed)
    wavs = [(rng.randn(n) * 0.1).astype(np.float32) for n in lengths]
    batch = np.zeros((len(lengths), L), np.float32)
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = w
    return wavs, batch


def test_ragged_codec_matches_jax_and_per_file_forward(tiny_codec):
    jcfg, params, cfg, codec = tiny_codec
    wavs, batch = _batch(LENGTHS, 1000)
    lens = np.asarray(LENGTHS, np.int32)
    j_recon, j_codes = jax_make_ragged_codec(jcfg)(params, jnp.asarray(batch), jnp.asarray(lens))
    recon, codes = make_ragged_codec(cfg, device="cpu")(codec, torch.from_numpy(batch),
                                                        torch.from_numpy(lens))
    assert codes.shape == (1, 3, 100) and recon.shape == (3, 1000)
    for i, w in enumerate(wavs):
        n = len(w) // 10
        np.testing.assert_array_equal(codes[:, i, :n].numpy(), np.asarray(j_codes)[:, i, :n])
        np.testing.assert_allclose(recon[i, :len(w)].numpy(), np.asarray(j_recon)[i, :len(w)],
                                   rtol=WAV_RTOL, atol=WAV_ATOL)
        with torch.no_grad():
            out = TC.forward(codec, {"wav": torch.from_numpy(w)[None]})
        np.testing.assert_array_equal(codes[:, i, :n].numpy(), out.vq_code[:, 0].numpy())
        np.testing.assert_allclose(recon[i, :len(w)].numpy(), out.gen_wav[0, 0].numpy(),
                                   rtol=WAV_RTOL, atol=WAV_ATOL)


def test_ragged_codec_zero_length_row_and_int16(tiny_codec):
    """A row of length 0 changes nothing for its neighbour; int16 PCM equals
    the same samples as float32 / 32768."""
    jcfg, params, cfg, codec = tiny_codec
    run = make_ragged_codec(cfg, device="cpu")
    pcm = np.random.RandomState(5).randint(-3000, 3000, (2, 500)).astype(np.int16)
    pcm[1] = 0
    f32 = pcm.astype(np.float32) / 32768.0
    recon, codes = run(codec, torch.from_numpy(pcm), torch.tensor([500, 0]))
    alone_recon, alone_codes = run(codec, torch.from_numpy(f32[:1]), torch.tensor([500]))
    assert torch.isfinite(recon).all()
    assert torch.equal(codes[:, 0], alone_codes[:, 0])
    np.testing.assert_allclose(recon[0].numpy(), alone_recon[0].numpy(),
                               rtol=WAV_RTOL, atol=WAV_ATOL)


def test_ragged_codec_fsq_matches_jax_and_per_file():
    """An FSQ codec (``quantizer: fsq``, levels (4, 4, 4, 8)) through the
    ragged codec: codes byte for byte against JAX's ragged codec and the
    port's per-file forward, reconstructions within rtol 1e-5 / atol 1e-6."""
    from test_torch_conformer_train import jax_tree
    from test_torch_fsq import spread

    jcfg = GE._tiny_config()
    jcfg.train.precision = "fp32"
    d = jcfg.model.codec_decoder
    d.quantizer, d.fsq_levels, d.codebook_size = "fsq", (4, 4, 4, 8), 512
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    codec = spread(TC.init_codec(cfg, generator=torch.Generator().manual_seed(6), device="cpu"))
    params = jax_tree(codec.state_dict())
    wavs, batch = _batch(LENGTHS, 1000, seed=6)
    lens = np.asarray(LENGTHS, np.int32)
    j_recon, j_codes = jax_make_ragged_codec(jcfg)(params, jnp.asarray(batch), jnp.asarray(lens))
    recon, codes = make_ragged_codec(cfg, device="cpu")(codec, torch.from_numpy(batch),
                                                        torch.from_numpy(lens))
    assert codes.shape == (1, 3, 100) and len(torch.unique(codes)) > 20
    for i, w in enumerate(wavs):
        n = len(w) // 10
        np.testing.assert_array_equal(codes[:, i, :n].numpy(), np.asarray(j_codes)[:, i, :n])
        np.testing.assert_allclose(recon[i, :len(w)].numpy(), np.asarray(j_recon)[i, :len(w)],
                                   rtol=WAV_RTOL, atol=WAV_ATOL)
        with torch.no_grad():
            out = TC.forward(codec, {"wav": torch.from_numpy(w)[None]})
        np.testing.assert_array_equal(codes[:, i, :n].numpy(), out.vq_code[:, 0].numpy())
        np.testing.assert_allclose(recon[i, :len(w)].numpy(), out.gen_wav[0, 0].numpy(),
                                   rtol=WAV_RTOL, atol=WAV_ATOL)


@pytest.mark.parametrize("change", [
    # the Conformer's MoE feed-forward: expert capacity is batch-global
    (("codec_encoder", "type", "conformer_stft"), ("codec_encoder", "ffn_type", "moe")),
    (("codec_decoder", "type", "conformer_istft"), ("codec_decoder", "ffn_type", "moe")),
    # the EMA VQ and LFQ quantize frame by frame, and the semantic branch's
    # bottleneck is masked per file: they build (a library quantizer no codec
    # selects raises JAX's ValueError in their place)
    (("codec_decoder", "quantizer", "ema_vq"),),
    (("codec_decoder", "quantizer", "lfq"), ("codec_decoder", "in_channels", 13),
     ("codec_encoder", "out_channels", 13)),
    (("train", "use_semantic", True),)],
    ids=["encoder.ffn_type=moe", "decoder.ffn_type=moe", "quantizer=ema_vq", "quantizer=lfq",
         "use_semantic=True"])
def test_ragged_codec_refuses_unported_families(change):
    cfg = PC.Config()
    for group, field, value in change:
        setattr(cfg.train if group == "train" else getattr(cfg.model, group), field, value)
    if cfg.model.codec_decoder.quantizer in ("ema_vq", "lfq") or cfg.train.use_semantic:
        assert callable(make_ragged_codec(cfg, device="cpu"))
        assert callable(make_ragged_tokenizer(cfg, device="cpu"))
        cfg.model.codec_decoder.quantizer = "rpq"
        with pytest.raises(ValueError, match="unknown quantizer rpq"):
            make_ragged_codec(cfg, device="cpu")
        return
    moe = any(v == "moe" for _, _, v in change)
    with pytest.raises(NotImplementedError,
                       match="capacity routing is batch-global" if moe else "ROADMAP"):
        make_ragged_codec(cfg, device="cpu")
