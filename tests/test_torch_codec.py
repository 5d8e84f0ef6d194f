"""The port's serving path (tokenize, codes_to_emb -> decode) against the JAX
package on the same parameters, converted with params_from_jax.

Tiny config: tokens byte for byte. Flagship width (Config(), one 0.2 s
request): latents and waveform within the repo's tolerances, tokens equal
except at frames whose JAX top-2 distance gap is under 1e-5."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu.config import Config as JaxConfig
from audiotokenization_tpu.config import load_config as jax_load_config
from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu.ops.conv import fold_weight_norm as jax_fold, linear as jax_linear
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.ops.conv import fold_weight_norm

from test_torch_conformer_train import jax_tree

LAT_RTOL, LAT_ATOL = 1e-3, 2e-4
WAV_RTOL, WAV_ATOL = 1e-3, 2e-5
GAP = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: parallel test workers share the cores, and idle
    threads of an oversubscribed pool spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(jcfg, params):
    """The port's codec on the CPU with the JAX tree's weights."""
    codec = TC.init_codec(PC.from_dict(dataclasses.asdict(jcfg)),
                          generator=torch.Generator().manual_seed(0), device="cpu")
    tree = jax.tree.map(np.asarray, params)
    if "w" in tree["encoder"]["conv_in"]:
        fold_weight_norm(codec)
    codec.load_state_dict(params_from_jax(tree))
    return codec


def _decode_both(jcfg, params, codec, codes):
    """codes (Nq, B, Tf) -> (JAX wav, port wav), both through codes_to_emb."""
    c = np.array(codes).transpose(1, 2, 0).copy()
    ref = jax.jit(lambda p, x: JC.decode(p, jcfg, JC.apply_fc_post_a(
        p, jcfg, JC.codes_to_emb(p, jcfg, x))))(params, jnp.asarray(c))
    with TC.full_fp32(), torch.no_grad():
        emb = TC.apply_fc_post_a(codec, TC.codes_to_emb(codec, torch.from_numpy(c)))
        got = TC.decode(codec, emb)
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("folded", [False, True])
def test_tiny_tokenize_is_byte_exact_and_decode_matches(folded):
    jcfg = GE._tiny_config()
    params = jax.jit(lambda k: JC.init_codec(k, jcfg))(jax.random.key(0))
    if folded:
        params = jax_fold(params)
    codec = _port(jcfg, params)
    wav = (np.random.RandomState(0).randn(3, 1600) * 0.1).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, w: JC.tokenize(p, jcfg, w, mode="conformant"))(
        params, jnp.asarray(wav)))
    got = TC.tokenize(codec, wav, mode="conformant")
    assert got.dtype == torch.int32 and got.shape == ref.shape == (1, 3, 160)
    np.testing.assert_array_equal(got.numpy(), ref)
    wav_ref, wav_got = _decode_both(jcfg, params, codec, ref)
    assert wav_got.shape == (3, 1, 1600)
    np.testing.assert_allclose(wav_got, wav_ref, rtol=WAV_RTOL, atol=WAV_ATOL)


@pytest.fixture(scope="module")
def flagship():
    """Config() with the port's initial weights from seed 0 and the JAX tree
    holding the same values (``jax_tree``: no JAX init), JAX's encode and
    quantize each jitted once (op by op, every primitive compiles at full
    width)."""
    jcfg = JaxConfig()
    codec = TC.init_codec(PC.from_dict(dataclasses.asdict(jcfg)),
                          generator=torch.Generator().manual_seed(0), device="cpu")
    params = jax_tree(codec.state_dict())
    wav = (np.random.RandomState(0).randn(1, 3200) * 0.1).astype(np.float32)
    lat = jax.jit(lambda p, w: JC.encode(p, jcfg, w))(params, jnp.asarray(wav))
    _, codes, _ = jax.jit(lambda p, x: JC.quantize(p, jcfg, x))(params, lat)
    return jcfg, params, codec, wav, np.asarray(lat), np.asarray(codes)


def _jax_top2_gap(params, lat):
    layer = params["quantizer"]["layers"][0]
    z = np.asarray(jax_linear(jnp.swapaxes(jnp.asarray(lat), 1, 2), layer["in_proj"]))
    e = z.reshape(-1, z.shape[-1]).astype(np.float64)
    c = np.asarray(layer["codebook"], np.float64)
    e /= np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
    c /= np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-12)
    d = np.sort((e * e).sum(1)[:, None] - 2 * e @ c.T + (c * c).sum(1)[None], axis=1)
    return d[:, 1] - d[:, 0]


def test_flagship_latents_and_tokens_match_jax(flagship):
    jcfg, params, codec, wav, lat_ref, codes_ref = flagship
    with TC.full_fp32(), torch.no_grad():
        lat = TC.encode(codec, torch.from_numpy(wav)).numpy()
    assert lat.shape == lat_ref.shape == (1, 1024, 16)
    np.testing.assert_allclose(lat, lat_ref, rtol=LAT_RTOL, atol=LAT_ATOL)
    codes = TC.tokenize(codec, wav).numpy()
    assert codes.shape == codes_ref.shape == (1, 1, 16)
    flips = (codes != codes_ref).reshape(-1)
    near = _jax_top2_gap(params, lat_ref) < GAP
    if flips.any():
        warnings.warn(f"{int(flips.sum())} flagship token(s) differ from JAX at "
                      f"near-tie frames {np.flatnonzero(flips).tolist()}")
    assert not (flips & ~near).any(), "tokens differ at frames with a top-2 gap >= 1e-5"


def test_flagship_decode_matches_jax(flagship):
    jcfg, params, codec, _, _, codes_ref = flagship
    wav_ref, wav_got = _decode_both(jcfg, params, codec, codes_ref)
    assert wav_got.shape == wav_ref.shape == (1, 1, 3200)
    np.testing.assert_allclose(wav_got, wav_ref, rtol=WAV_RTOL, atol=WAV_ATOL)


def test_entry_points_default_to_cuda_and_never_fall_back():
    g = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TC.init_codec(PC.Config(), generator=g)


def test_tokenize_modes_not_ported_raise():
    """Every tokenize mode is ported now (tests/test_torch_modes.py holds
    them against JAX): each returns (Nq, B, Tf) int32; an unknown mode
    raises."""
    jcfg = GE._tiny_config()
    codec = TC.init_codec(PC.from_dict(dataclasses.asdict(jcfg)),
                          generator=torch.Generator().manual_seed(0), device="cpu")
    wav = np.zeros((1, 400), np.float32)
    with torch.backends.mkldnn.flags(enabled=False):
        for mode in ("high", "balanced", "fast"):
            codes = TC.tokenize(codec, wav, mode=mode)
            assert codes.dtype == torch.int32 and codes.shape == (1, 1, 40)
    with pytest.raises(ValueError):
        TC.tokenize(codec, wav, mode="bogus")


def test_variants_not_ported_raise():
    """Causal and anti-aliased codecs build now, their units off K2 (the
    route is fixed by the config); the Conformer builds with its MoE
    feed-forward, and FSQ builds; LFQ (13 bits) builds with no parameters,
    and a library quantizer no codec selects (SimVQ) raises JAX's
    ValueError."""
    cfg = PC.Config()
    cfg.model.codec_encoder.causal = True
    cfg.model.codec_decoder.antialias = True
    codec = TC.Codec(cfg, generator=torch.Generator().manual_seed(0))
    assert not any(u.fused for b in codec.encoder.blocks for u in b.units)
    assert not any(u.fused for b in codec.decoder.blocks for u in b.units)
    cfg = PC.Config()
    cfg.model.codec_encoder.type = "conformer_stft"
    cfg.model.codec_encoder.ffn_type = "moe"
    cfg.model.codec_decoder.fsq = True
    codec = TC.Codec(cfg, generator=torch.Generator().manual_seed(0))
    assert codec.encoder_moe and type(codec.quantizer).__name__ == "FSQ"
    cfg.model.codec_decoder.fsq, cfg.model.codec_decoder.quantizer = False, "lfq"
    cfg.model.codec_encoder.out_channels = cfg.model.codec_decoder.in_channels = 13
    codec = TC.Codec(cfg, generator=torch.Generator().manual_seed(0))
    assert list(codec.quantizer.parameters()) == []
    cfg.model.codec_decoder.quantizer = "sim_vq"
    with pytest.raises(ValueError, match="unknown quantizer sim_vq"):
        TC.Codec(cfg, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("path", [None, "configs/bigcodec.yaml", "configs/bigcodec_debug.yaml"])
def test_config_matches_jax(path):
    """Same groups, names and defaults, and the repo's YAML loads the same."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    full = None if path is None else root / path
    overrides = ["model.codec_decoder.codebook_size=4096"]
    assert (dataclasses.asdict(PC.load_config(full, overrides))
            == dataclasses.asdict(jax_load_config(full, overrides)))
