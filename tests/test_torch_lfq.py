"""The port's lookup-free quantizer (``models/quantizers/lfq.py``) and the
LFQ BigCodec (the tiny config of tests/test_train_step.py with ``quantizer:
lfq``, an 8-bit latent, 256 codes) against the JAX package's (CPU, seeded
numpy inputs):

- ``lfq_apply`` in eval and training, plain, spherical (BSQ), with a
  ``codebook_scale`` and both: indices equal, quantized, the entropy aux and
  commitment losses within rtol 1e-5 / atol 1e-6; d/dx of the losses and a
  downstream sum within rtol 1e-4; ``lfq_indices_to_codes`` equal over all
  256 codes;
- the tiny codec: tokens byte for byte against JAX ``tokenize``
  (conformant and high), ``codes_to_emb`` equal and decode within rtol 1e-3
  / atol 2e-5, the ragged tokenizer and codec equal to per file, a causal
  variant streamed equal to offline;
- one fp32 training step against ``jit_train_step`` from the same weights
  (AdamW eps 1, no warmup): metrics rtol 1e-4 / atol 1e-6, the 256-bin
  histogram equal, updates as tests/test_torch_train.py holds them;
- configs: an LFQ codec wider than 31 bits is refused, the full-width
  13-bit LFQ flagship builds with no quantizer parameters.

The two-process all-reduce of the code probabilities is in
tests/test_torch_ema_vq.py (one gloo pair for both quantizers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu.models.quantizers import lfq as JL
from audiotokenization_tpu.train.step import make_train_step as jax_make_train_step
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.models.quantizers import lfq as TL
from audiotokenization_tpu_torch.models.streaming import StreamingTokenizer, stream_decode
from audiotokenization_tpu_torch.train.step import make_train_step
from audiotokenization_tpu_torch.utils.ragged import make_ragged_codec, make_ragged_tokenizer

from test_torch_conformer_train import jax_tree, states
from test_torch_train import KEYS, hold_update, jax_leaves, leaves, smooth

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4
WAV_RTOL, WAV_ATOL = 1e-3, 2e-5
BITS = 8
HOP = 10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


VARIANTS = {"plain": {}, "spherical": {"spherical": True}, "scaled": {"codebook_scale": 0.5},
            "spherical_scaled": {"spherical": True, "codebook_scale": 0.25}}


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_apply_matches_jax(variant, training):
    kw = VARIANTS[variant]
    x = np.random.RandomState(0).randn(2, BITS, 50).astype(np.float32)
    want = JL.lfq_apply(jnp.asarray(x), training=training, **kw)
    got = TL.lfq_apply(torch.from_numpy(x), training=training, **kw)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert got.indices.dtype == torch.int32 and len(np.unique(np.asarray(want.indices))) > 50
    for name in ("quantized", "entropy_aux_loss", "commit_loss"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        assert getattr(got, name).shape == np.shape(getattr(want, name)), name
    if training:
        assert float(got.entropy_aux_loss) != 0.0 and float(got.commit_loss.sum()) > 0


@pytest.mark.parametrize("variant", ["plain", "spherical"])
def test_gradients_match_jax(variant):
    kw = VARIANTS[variant]
    rs = np.random.RandomState(1)
    x = rs.randn(2, BITS, 30).astype(np.float32)
    r = rs.randn(2, BITS, 30).astype(np.float32)

    def jax_loss(x):
        res = JL.lfq_apply(x, training=True, **kw)
        return res.entropy_aux_loss + jnp.sum(res.commit_loss) + jnp.sum(res.quantized * r)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    res = TL.lfq_apply(xt, training=True, **kw)
    (got,) = torch.autograd.grad(res.entropy_aux_loss + res.commit_loss.sum()
                                 + (res.quantized * torch.from_numpy(r)).sum(), xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("spherical", [False, True], ids=["plain", "spherical"])
def test_indices_to_codes_match_jax(spherical):
    idx = np.arange(2 ** BITS, dtype=np.int32)
    want = np.asarray(JL.lfq_indices_to_codes(jnp.asarray(idx), codebook_dim=BITS,
                                              spherical=spherical))
    got = TL.lfq_indices_to_codes(torch.from_numpy(idx), codebook_dim=BITS, spherical=spherical)
    np.testing.assert_array_equal(got.numpy(), want)
    # the codes' own signs index them back
    back = TL.lfq_apply(got.T[None], spherical=spherical).indices.numpy()[0]
    np.testing.assert_array_equal(back, idx)


# -- the LFQ BigCodec -------------------------------------------------------------

def tiny_lfq(causal=False):
    jcfg = GE._tiny_config()
    jcfg.train.precision = "fp32"
    d = jcfg.model.codec_decoder
    d.quantizer, d.in_channels, d.codebook_size = "lfq", BITS, 2 ** BITS
    jcfg.model.codec_encoder.out_channels = BITS
    for part in (jcfg.model.codec_encoder, d):
        part.causal = causal
    return jcfg


def spread(codec):
    """Zero the encoder's LSTM and output biases: at init they set most of
    the latents' signs. In place."""
    with torch.no_grad():
        for name, p in codec.named_parameters():
            if name.startswith(("encoder.lstm.bias", "encoder.conv_out.b")):
                p.zero_()
    return codec


def build(jcfg, seed):
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    codec = spread(TC.init_codec(cfg, generator=torch.Generator().manual_seed(seed),
                                 device="cpu"))
    assert list(codec.quantizer.parameters()) == [] and codec.quantizer.state_dict() == {}
    return jax.tree.map(np.asarray, jax_tree(codec.state_dict())), cfg, codec


def wav_batch(seed, n=3, t=1600):
    return (np.random.RandomState(seed).randn(n, t) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def lfq_codec():
    jcfg = tiny_lfq()
    return (jcfg, *build(jcfg, 5))


@pytest.mark.parametrize("mode", ["conformant", "high"])
def test_codec_tokens_match_jax(lfq_codec, mode):
    jcfg, params, cfg, codec = lfq_codec
    wav = wav_batch(6)
    want = np.asarray(JC.tokenize(params, jcfg, jnp.asarray(wav)))
    got = TC.tokenize(codec, torch.from_numpy(wav), mode=mode).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (1, 3, 160)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 20 and (want < 2 ** BITS).all()


def port_decode(codec, codes):
    with TC.full_fp32(), torch.no_grad():
        return TC.decode(codec, TC.codes_to_emb(codec, torch.from_numpy(codes).long()
                                                .permute(1, 2, 0))).numpy()


def test_codec_decode_matches_jax(lfq_codec):
    jcfg, params, cfg, codec = lfq_codec
    codes = np.random.RandomState(7).randint(0, 2 ** BITS, (1, 2, 40)).astype(np.int32)
    emb = JC.codes_to_emb(params, jcfg, jnp.moveaxis(jnp.asarray(codes), 0, -1))
    got_emb = TC.codes_to_emb(codec, torch.from_numpy(codes).long().permute(1, 2, 0))
    np.testing.assert_array_equal(got_emb.numpy(), np.asarray(emb))
    with jax.default_matmul_precision("float32"):
        want = np.asarray(JC.decode(params, jcfg, emb))
    np.testing.assert_allclose(port_decode(codec, codes), want, rtol=WAV_RTOL, atol=WAV_ATOL)


def test_ragged_matches_per_file(lfq_codec):
    jcfg, params, cfg, codec = lfq_codec
    lens = [730, 400, 1000]
    wav = wav_batch(8, t=1000)
    for i, n in enumerate(lens):
        wav[i, n:] = 0
    codes = make_ragged_tokenizer(cfg, device="cpu")(codec, torch.from_numpy(wav),
                                                      torch.tensor(lens))
    recon, rcodes = make_ragged_codec(cfg, device="cpu")(codec, torch.from_numpy(wav),
                                                        torch.tensor(lens))
    for i, n in enumerate(lens):
        own = TC.tokenize(codec, torch.from_numpy(wav[i:i + 1, :n]))
        assert torch.equal(codes[:, i:i + 1, :n // HOP], own)
        assert torch.equal(rcodes[:, i:i + 1, :n // HOP], own)
        want = port_decode(codec, own.numpy())[0, 0]
        np.testing.assert_allclose(recon[i, :n].numpy(), want, rtol=WAV_RTOL, atol=WAV_ATOL)


def test_streaming_matches_offline():
    params, cfg, codec = build(tiny_lfq(causal=True), 9)
    wav = torch.from_numpy(wav_batch(10, n=2, t=1200))
    chunk = 200
    tok = StreamingTokenizer(codec, chunk_samples=chunk, device="cpu")
    state, pieces = tok.init_state(batch_size=2), []
    for start in range(0, wav.shape[1], chunk):
        codes, state = tok.step(state, wav[:, start:start + chunk])
        pieces.append(codes)
    tail, _ = tok.flush(state)
    streamed = torch.cat(pieces + [tail], dim=2)
    offline = TC.tokenize(codec, wav)
    assert streamed.shape == offline.shape == (1, 2, 120)
    assert torch.equal(streamed, offline) and len(torch.unique(offline)) > 10
    got = stream_decode(codec, offline, chunk_frames=16, device="cpu").numpy()
    np.testing.assert_allclose(got, port_decode(codec, offline.numpy())[:, 0], rtol=WAV_RTOL,
                               atol=WAV_ATOL)


def test_train_step_matches_jax():
    jcfg = smooth(tiny_lfq())
    cfg, port, jstate = states(jcfg, 13, edit=spread)
    wav = wav_batch(14, n=2, t=800)
    jb, pb = jax_leaves(jstate), leaves(port)
    jstate, jm = jax.jit(jax_make_train_step(jcfg))(jstate, {"wav": jnp.asarray(wav)})
    pm = make_train_step(cfg, device="cpu")(port, {"wav": torch.from_numpy(wav)})
    ja, pa = jax_leaves(jstate), leaves(port)
    for key in KEYS:
        np.testing.assert_allclose(np.asarray(pm[key]), np.asarray(jm[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    assert float(pm["vq_loss"]) != 0.0  # mean commitment + the entropy aux loss
    assert pm["codebook_hist"].shape == (2 ** BITS,)
    np.testing.assert_array_equal(pm["codebook_hist"].numpy(), np.asarray(jm["codebook_hist"]))
    assert set(pm) == set(jm) and set(pa) == set(ja)
    assert not any(k.startswith("gen.quantizer.") for k in pa)
    for name in ja:
        if np.array_equal(ja[name], jb[name]):  # an update below the fp32 spacing
            np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)
        else:
            hold_update(name, (pb[name], pa[name]), (jb[name], ja[name]))


def test_configs():
    cfg = PC.from_dict(dataclasses.asdict(tiny_lfq()))
    cfg.model.codec_decoder.in_channels = cfg.model.codec_encoder.out_channels = 32
    with pytest.raises(ValueError, match="31"):
        TC.check_config(cfg)
    flagship = PC.Config()
    d = flagship.model.codec_decoder
    d.quantizer, d.in_channels, d.codebook_size = "lfq", 13, 8192
    flagship.model.codec_encoder.out_channels = 13
    codec = TC.Codec(flagship, generator=torch.Generator().manual_seed(0))
    assert list(codec.quantizer.parameters()) == [] and PC.num_codebooks(flagship) == 1
    assert codec.decoder.conv_in.v.shape[1] == 13
    assert all(u.fused for b in codec.encoder.blocks for u in b.units)
