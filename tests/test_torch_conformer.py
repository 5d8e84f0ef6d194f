"""The port's Conformer STFT/ISTFT codec against the JAX package's (CPU, the
tiny Conformer of tests/test_conformer_train.py with 2 layers a side, the
same weights through params_from_jax, seeded inputs):

- ``stft_same_constant_pad`` and ``istft_same`` (with and without a
  ragged ``valid``) within 1e-5;
- ``apply_rope`` and the RoPE tables, ``self_attention`` (plain, masked,
  causal, both) and ``conformer_layer`` in both orders, with and without
  ``valid``, within 1e-5;
- encoder latents within rtol 1e-3 / atol 2e-4, decoder waveforms within
  rtol 1e-3 / atol 2e-5, tokens byte for byte, non-causal and causal;
- the ``high`` and ``fast`` tokenize modes against JAX's (high token for
  token; fast latents within 5e-2 x max |latent| and tokens on at least
  95% of the frames), and ``balanced`` raising;
- ``convert_codec_state_dict`` of a synthetic reference-layout state dict
  (with the weight-normed projections) giving JAX's tree and outputs, and
  ``load_reference_checkpoint`` on a reference run dir;
- ``configs/conformer.yaml`` at full width, 1 x 1 s (tokens but at top-2
  gaps under 1e-5, latents, waveform);
- the MoE feed-forward building, and the ragged path refusing it.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu import config as JCF
from audiotokenization_tpu import convert as JV
from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu.ops import stft as JS
from audiotokenization_tpu.ops import transformer as JT
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch import convert as TV
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.models import conformer as TM
from audiotokenization_tpu_torch.ops import stft as TS
from audiotokenization_tpu_torch.ops import transformer as TT
from audiotokenization_tpu_torch.ops.cuda.vq_kernel import l2_normalize
from audiotokenization_tpu_torch.ops.conv import linear
from audiotokenization_tpu_torch.utils.ragged import make_ragged_tokenizer

from test_conformer_train import conformer_tiny_config
from test_torch_convert import reference_hydra_config

OP_TOL = 1e-5
LAT_RTOL, LAT_ATOL = 1e-3, 2e-4
WAV_RTOL, WAV_ATOL = 1e-3, 2e-5
LAT_REL, AGREE = 5e-2, 0.95   # the bf16 mode, as tests/test_torch_modes.py holds it
GAP = 1e-5                    # near-tie threshold of the full-width token comparison
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


def tiny(causal=False, layers=2, channels=None):
    """The tiny Conformer; ``channels``: latent width other than dim (the
    weight-normed projections then exist)."""
    jcfg = conformer_tiny_config()
    for part in (jcfg.model.codec_encoder, jcfg.model.codec_decoder):
        part.causal, part.n_layers = causal, layers
    if channels is not None:
        jcfg.model.codec_encoder.out_channels = channels
        jcfg.model.codec_decoder.in_channels = channels
    return jcfg


def build(jcfg, seed):
    params = jax.tree.map(np.asarray, JC.init_codec(jax.random.key(seed), jcfg))
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    codec = TC.init_codec(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    codec.load_state_dict(params_from_jax(params))
    return params, codec


@pytest.fixture(scope="module")
def models():
    """Per causality: (jcfg, JAX params, the port's codec)."""
    out = {}
    for causal, seed in ((False, 0), (True, 1)):
        jcfg = tiny(causal)
        out[causal] = (jcfg, *build(jcfg, seed))
    return out


def wav_batch(seed, n=2, frames=30):
    return (np.random.RandomState(seed).randn(n, frames * HOP) * 0.1).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


# -- spectral ops ------------------------------------------------------------

def test_stft_same_constant_pad_matches_jax():
    x = wav_batch(3, frames=12)
    want = np.asarray(JS.stft_same_constant_pad(jnp.asarray(x), n_fft=160, hop_length=40,
                                                win_length=160))
    got = TS.stft_same_constant_pad(t(x), n_fft=160, hop_length=40, win_length=160).numpy()
    assert got.shape == want.shape == (2, 81, 12)
    np.testing.assert_allclose(got, want, rtol=OP_TOL, atol=OP_TOL)


@pytest.mark.parametrize("valid", [None, (12, 7)], ids=["dense", "valid"])
def test_istft_same_matches_jax(valid):
    rs = np.random.RandomState(4)
    spec = (rs.randn(2, 81, 12) + 1j * rs.randn(2, 81, 12)).astype(np.complex64)
    jvalid = None if valid is None else jnp.asarray(valid)
    want = np.asarray(JS.istft_same(jnp.asarray(spec), n_fft=160, hop_length=40,
                                    win_length=160, valid=jvalid))
    got = TS.istft_same(t(spec), n_fft=160, hop_length=40, win_length=160,
                        valid=None if valid is None else torch.tensor(valid)).numpy()
    assert got.shape == want.shape == (2, 480)
    for i, n in enumerate(valid or (12, 12)):  # past a sample's frames: meaningless
        np.testing.assert_allclose(got[i, :n * 40], want[i, :n * 40], rtol=OP_TOL, atol=OP_TOL)
    assert np.isfinite(got).all()


# -- transformer blocks --------------------------------------------------------

def test_rope_matches_jax():
    jc, js = JT.precompute_rope(16, 50, 500.0)
    tc, ts = TT.precompute_rope(16, 50, 500.0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    x = np.random.RandomState(5).randn(2, 50, 2, 16).astype(np.float32)
    want = np.asarray(JT.apply_rope(jnp.asarray(x), jc, js))
    np.testing.assert_allclose(TT.apply_rope(t(x), tc, ts).numpy(), want, rtol=OP_TOL,
                               atol=OP_TOL)


def _layer(models, causal=False):
    jcfg, params, codec = models[causal]
    return params["encoder"]["backbone"]["layers"][0], codec.encoder.backbone.layers[0]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("valid", [None, (20, 13)], ids=["dense", "valid"])
def test_self_attention_matches_jax(models, causal, valid):
    jp, tp = _layer(models)
    x = np.random.RandomState(6).randn(2, 32, 20).astype(np.float32)  # (B, C, T)
    cos, sin = JT.precompute_rope(16, 20, 500.0)
    jvalid = None if valid is None else jnp.asarray(valid)
    want = np.asarray(JT.self_attention(jnp.asarray(x), jp["attn"], cos, sin, n_head=2,
                                        causal=causal, valid=jvalid))
    tvalid = None if valid is None else torch.tensor(valid)
    bias = TT.attention_bias(20, valid=tvalid, causal=causal, dtype=torch.float32,
                             device=torch.device("cpu"))
    with TC.full_fp32(), torch.no_grad():
        got = TT.self_attention(t(x).transpose(1, 2), tp.attn, t(cos), t(sin), n_head=2,
                                bias=bias, causal=causal).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=OP_TOL, atol=OP_TOL)


@pytest.mark.parametrize("conv_first", [True, False], ids=["conv_first", "attn_first"])
@pytest.mark.parametrize("valid", [None, (20, 13)], ids=["dense", "valid"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_conformer_layer_matches_jax(models, conv_first, valid, causal):
    jp, tp = _layer(models, causal)
    x = np.random.RandomState(7).randn(2, 32, 20).astype(np.float32)
    cos, sin = JT.precompute_rope(16, 20, 500.0)
    jvalid = None if valid is None else jnp.asarray(valid)
    want = np.asarray(JT.conformer_layer(jnp.asarray(x), jp, cos, sin, n_head=2,
                                         conv_first=conv_first, causal=causal, valid=jvalid))
    with TC.full_fp32(), torch.no_grad():
        got = TT.conformer_layer(t(x).transpose(1, 2), tp, t(cos), t(sin), n_head=2,
                                 conv_first=conv_first, causal=causal,
                                 valid=None if valid is None else torch.tensor(valid))
    got = got.transpose(1, 2).numpy()
    for i, n in enumerate(valid or (20, 20)):
        np.testing.assert_allclose(got[i, :, :n], want[i, :, :n], rtol=OP_TOL, atol=OP_TOL)


# -- the codec -----------------------------------------------------------------

def jax_decode(params, jcfg, codes):
    emb = JC.codes_to_emb(params, jcfg, jnp.moveaxis(jnp.asarray(codes), 0, -1))
    with jax.default_matmul_precision("float32"):
        return np.asarray(JC.decode(params, jcfg, emb))


def port_decode(codec, codes):
    with TC.full_fp32(), torch.no_grad():
        return TC.decode(codec, TC.codes_to_emb(codec, t(codes).long().permute(1, 2, 0))).numpy()


@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
def test_codec_matches_jax(models, causal):
    """Latents, tokens byte for byte, and the decode of those tokens."""
    jcfg, params, codec = models[causal]
    wav = wav_batch(8 + causal)
    with jax.default_matmul_precision("float32"):
        want_lat = np.asarray(JC.encode(params, jcfg, jnp.asarray(wav)))
    want_codes = np.asarray(JC.tokenize(params, jcfg, jnp.asarray(wav)))
    with TC.full_fp32(), torch.no_grad():
        lat = TC.encode(codec, t(wav)).numpy()
    codes = TC.tokenize(codec, t(wav)).numpy()
    assert lat.shape == want_lat.shape == (2, 32, 30)
    np.testing.assert_allclose(lat, want_lat, rtol=LAT_RTOL, atol=LAT_ATOL)
    assert codes.dtype == np.int32 and codes.shape == (1, 2, 30)
    np.testing.assert_array_equal(codes, want_codes)
    assert len(np.unique(codes)) > 4  # the comparison is not between two constants
    got, want = port_decode(codec, codes), jax_decode(params, jcfg, want_codes)
    assert got.shape == want.shape == (2, 1, 30 * HOP)
    np.testing.assert_allclose(got, want, rtol=WAV_RTOL, atol=WAV_ATOL)


@pytest.mark.parametrize("mode", ["high", "fast"])
def test_tokenize_modes_match_jax(models, mode):
    jcfg, params, codec = models[False]
    wav = wav_batch(10)
    want = np.asarray(JC.tokenize(params, jcfg, jnp.asarray(wav), mode=mode))
    with torch.backends.mkldnn.flags(enabled=False):
        got = TC.tokenize(codec, t(wav), mode=mode).numpy()
    assert got.shape == want.shape
    if mode == "high":  # no TF32 on the CPU
        np.testing.assert_array_equal(got, want)
        return
    enc16 = {**params, "encoder": JC._cast_tree(params["encoder"], jnp.bfloat16)}
    want_lat = np.asarray(JC.encode(enc16, jcfg, jnp.asarray(wav, jnp.bfloat16)), np.float32)
    with torch.backends.mkldnn.flags(enabled=False):
        lat = TC.encode_in_mode(codec.encoder, t(wav)[:, None], "fast").numpy()
    assert np.abs(lat - want_lat).max() <= LAT_REL * np.abs(want_lat).max()
    assert (got == want).mean() >= AGREE


def test_balanced_mode_raises(models):
    jcfg, _, codec = models[False]
    with pytest.raises(ValueError, match="ConformerEncoder has no 'balanced'"):
        TC.tokenize(codec, t(wav_batch(11)), mode="balanced")
    with pytest.raises(ValueError, match="ConformerEncoder has no 'balanced'"):
        make_ragged_tokenizer(codec.cfg, mode="balanced", device="cpu")


def test_fast_mode_casts_the_encoder_once(models):
    """The bf16 copies of ``fast`` are made once per encoder and made again
    only after a parameter changes in place."""
    _, _, codec = models[False]
    wav = t(wav_batch(12))
    first = TC.tokenize(codec, wav, mode="fast")
    copies = TC.bf16_copies(codec.encoder)
    assert all(v.dtype == torch.bfloat16 for v in copies.values())
    assert len(copies) == len(list(codec.encoder.named_parameters()))
    assert torch.equal(TC.tokenize(codec, wav, mode="fast"), first)
    assert TC.bf16_copies(codec.encoder) is copies
    w = codec.encoder.input_proj.w
    with torch.no_grad():
        w.mul_(2.0)
    try:
        fresh = TC.bf16_copies(codec.encoder)
        assert fresh is not copies
        name = next(n for n, p in codec.encoder.named_parameters() if p is w)
        assert torch.equal(fresh[name], w.detach().to(torch.bfloat16))
    finally:
        with torch.no_grad():
            w.mul_(0.5)
    assert torch.equal(TC.tokenize(codec, wav, mode="fast"), first)


def test_codec_refuses_the_moe_feed_forward():
    """The MoE feed-forward builds (the encoder's; the decoder's stays dense,
    as JAX builds it), and the batched ragged path refuses it with JAX's
    reason: expert capacity is batch-global."""
    for part in ("codec_encoder", "codec_decoder"):
        cfg = PC.from_dict(dataclasses.asdict(tiny()))
        getattr(cfg.model, part).ffn_type = "moe"
        codec = TC.Codec(cfg, generator=torch.Generator().manual_seed(0))
        assert codec.encoder_moe == (part == "codec_encoder")
        with pytest.raises(NotImplementedError, match="capacity routing is batch-global"):
            make_ragged_tokenizer(cfg, device="cpu")


# -- reference checkpoints -------------------------------------------------------

def reference_conformer_state_dict(tree) -> dict:
    """A reference-layout Lightning state dict (ConformerEncoderSTFT /
    ConformerDecoderISTFT names) holding the JAX tree ``tree``."""
    sd = {}

    def conv(prefix, p):
        if "v" in p:
            sd[prefix + "weight_v"], sd[prefix + "weight_g"] = t(p["v"]), t(p["g"])
        else:
            sd[prefix + "weight"] = t(p["w"])
        if "b" in p:
            sd[prefix + "bias"] = t(p["b"])

    def backbone(prefix, p):
        for i, lp in enumerate(p["layers"]):
            pre = f"{prefix}conformer_backbone.layers.{i}."
            for ffn in ("ffn1", "ffn2"):
                for w in ("w1", "w2", "w3"):
                    conv(f"{pre}{ffn}.{w}.", lp[ffn][w])
            conv(pre + "self_attn.qkv_proj.", lp["attn"]["qkv"])
            conv(pre + "self_attn.out_proj.", lp["attn"]["out"])
            for ours, theirs in (("pw1", "pointwise_conv1"), ("dw", "depthwise_conv"),
                                 ("pw2", "pointwise_conv2")):
                conv(f"{pre}conv.{theirs}.", lp["conv"][ours])
            sd[pre + "conv.conv_norm.weight"] = t(lp["conv"]["norm"])
            for ours, theirs in (("attn_norm", "attn_norm_in"), ("conv_norm", "conv_norm_in"),
                                 ("ffn1_norm", "ffn1_norm_in"), ("ffn2_norm", "ffn2_norm_in")):
                sd[f"{pre}{theirs}.weight"] = t(lp[ours])

    enc, dec = tree["encoder"], tree["decoder"]
    conv("encoder.input_proj.", enc["input_proj"])
    sd["encoder.input_norm.weight"] = t(enc["input_norm"])
    backbone("encoder.", enc["backbone"])
    sd["encoder.norm.weight"] = t(enc["norm"])
    conv("encoder.output_proj.", enc["output_proj"])
    conv("decoder.input_proj.", dec["input_proj"])
    backbone("decoder.", dec["backbone"])
    sd["decoder.norm.weight"] = t(dec["norm"])
    conv("decoder.head.out.", dec["head_out"])
    for q, layer in enumerate(tree["quantizer"]["layers"]):
        pre = f"decoder.quantizer.layers.{q}."
        sd[pre + "_codebook.weight"] = t(layer["codebook"])
        conv(pre + "in_proj.", layer["in_proj"])
        conv(pre + "out_proj.", layer["out_proj"])
    return sd


@pytest.fixture(scope="module")
def projected():
    """The tiny Conformer with 16-channel latents (weight-normed input and
    output projections), its JAX tree and its reference state dict."""
    jcfg = tiny(channels=16)
    params, codec = build(jcfg, 12)
    return jcfg, params, codec, reference_conformer_state_dict(params)


def test_convert_reference_state_dict_matches_the_jax_tree(projected):
    jcfg, params, codec, sd = projected
    # the synthetic dict is what the JAX package's converter reads as this tree
    back = JV.convert_codec_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    got = TV.convert_codec_state_dict(sd, codec.cfg)
    want = codec.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    converted = TC.Codec(codec.cfg, generator=torch.Generator().manual_seed(1)).eval()
    converted.load_state_dict(got)
    wav = wav_batch(13)
    codes = TC.tokenize(converted, t(wav)).numpy()
    np.testing.assert_array_equal(codes, np.asarray(JC.tokenize(params, jcfg, jnp.asarray(wav))))
    np.testing.assert_allclose(port_decode(converted, codes), jax_decode(params, jcfg, codes),
                               rtol=WAV_RTOL, atol=WAV_ATOL)


def test_load_reference_checkpoint_reads_a_conformer_run(projected, tmp_path):
    import yaml

    jcfg, _, codec, sd = projected
    (tmp_path / "hydra").mkdir()
    (tmp_path / "hydra" / "config.yaml").write_text(yaml.safe_dump(reference_hydra_config(jcfg)))
    (tmp_path / "pl_log").mkdir()
    torch.save({"state_dict": sd}, tmp_path / "pl_log" / "last.ckpt")
    cfg, loaded = TV.load_reference_checkpoint(tmp_path, device="cpu")
    assert cfg.model.codec_encoder.type == "conformer_stft"
    assert cfg.model.codec_decoder.hop_length == HOP
    for k, v in codec.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


# -- configs/conformer.yaml at full width -------------------------------------------

def test_full_width_conformer_matches_jax():
    jcfg = JCF.load_config(ROOT / "configs" / "conformer.yaml")
    cfg = PC.load_config(ROOT / "configs" / "conformer.yaml")
    assert PC.to_dict(cfg) == dataclasses.asdict(jcfg)
    params, codec = build(jcfg, 0)
    wav = (np.random.RandomState(14).randn(1, 16000) * 0.1).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want_lat = np.asarray(JC.encode(params, jcfg, jnp.asarray(wav)))
    want_codes = np.asarray(JC.tokenize(params, jcfg, jnp.asarray(wav)))
    with TC.full_fp32(), torch.no_grad():
        lat = TC.encode(codec, t(wav))
        layer = codec.quantizer.layers[0]
        z = l2_normalize(linear(lat.transpose(1, 2), layer.in_proj)[0])
        d = torch.cdist(z, l2_normalize(layer.codebook)) ** 2
    codes = TC.tokenize(codec, t(wav)).numpy()
    assert codes.shape == want_codes.shape == (1, 1, 80)
    np.testing.assert_allclose(lat.numpy(), want_lat, rtol=LAT_RTOL, atol=LAT_ATOL)
    gap = d.topk(2, dim=1, largest=False).values
    near = (gap[:, 1] - gap[:, 0] < GAP).numpy()
    differ = (codes != want_codes).reshape(-1)
    assert not (differ & ~near).any()
    got, want = port_decode(codec, want_codes), jax_decode(params, jcfg, want_codes)
    assert got.shape == want.shape == (1, 1, 16000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=WAV_RTOL, atol=WAV_ATOL)
