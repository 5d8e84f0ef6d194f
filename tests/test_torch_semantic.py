"""The semantic codec (``train.use_semantic``, configs/bigcodec_semantic.yaml's
branch) against the JAX package's, on the tests' tiny codec with a
1024-wide teacher of 3 layers, 4 heads, intermediate 128, tapped at layer
2, with and without ``concat_semantic``. The JAX tree is built from the
port's random init (``test_torch_conformer_train.py::jax_tree``), the
biases that put every frame on one code zeroed; the teacher's output is a
seeded (B, 1024, Tf) target:

- ``tokenize`` in each mode against JAX's: conformant and high (fp32 on
  the CPU) byte-exact; balanced and fast (bf16 copies of the encoder, oneDNN
  off: this CPU build's oneDNN bf16 convolution is wrong where the kernel
  is wider than the padded input) byte-exact with concat, and the quantizer's
  input within 5e-2 x its max in both variants. Without concat the two
  packages' bf16 encoders round apart enough to move near-ties (2 and 4 of
  320 tokens), so there the tokens are held by tests/test_torch_modes.py's
  rule (equal on at least 95% of the frames) and every frame that differs
  must be a near-tie of JAX's quantizer input: the port's code is JAX's
  runner-up, at a top-2 gap among the smallest 2% of the frames' gaps;
- the quantizer's input (``semantic_vq_in`` of the latents) within
  latents' rtol 1e-3 / atol 2e-4; ``codes_to_emb`` -> ``apply_fc_post_a``
  -> ``decode`` within the waveforms' rtol 1e-3 / atol 2e-5
  (tests/test_parity_bigcodec.py);
- the ragged tokenizer and codec on 3 files of unequal length, each row's
  teacher zero past its frames, against each file alone: tokens equal,
  waveforms within the waveforms' tolerance;
- a reference checkpoint with the semantic heads (converted) and a JAX run
  dir (through scripts/jax_run_to_torch.py) tokenize as JAX does;
- ``concat_semantic`` without the teacher raises JAX's ``ValueError``, and
  so does the streaming tokenizer's ``NotImplementedError``.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu import convert as JV
from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch import convert as TV
from audiotokenization_tpu_torch.cli import extract_indices
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.models.streaming import StreamingTokenizer
from audiotokenization_tpu_torch.ops.conv import linear
from audiotokenization_tpu_torch.ops.cuda.vq_kernel import l2_normalize
from audiotokenization_tpu_torch.utils.ragged import make_ragged_codec, make_ragged_tokenizer

from test_torch_conformer_train import jax_tree
from test_torch_convert import reference_state_dict, write_jax_run, write_reference_run
from test_torch_streaming import jax_ref

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import jax_run_to_torch  # noqa: E402

LAT_RTOL, LAT_ATOL = 1e-3, 2e-4
WAV_RTOL, WAV_ATOL = 1e-3, 2e-5
HOP = 10
B, T = 2, 1600
LENGTHS = [730, 400, 1000]
MODES = ("conformant", "high", "balanced", "fast")
EXACT = ("conformant", "high")
BF16_LAT_REL, BF16_AGREE = 5e-2, 0.95  # tests/test_torch_modes.py's bf16-mode rule
NEAR_TIE = 0.02  # a differing frame's gap lies among this share of the smallest


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def semantic_tiny(concat: bool):
    """The tiny codec (fp32) with the semantic branch and a small teacher."""
    jcfg = GE._tiny_config()
    t = jcfg.train
    t.precision = "fp32"
    t.use_semantic, t.concat_semantic = True, concat
    t.teacher_layers, t.teacher_heads, t.teacher_intermediate, t.teacher_layer = 3, 4, 128, 2
    return jcfg


def spread(codec):
    """Zero the biases that put every frame on one code at init."""
    with torch.no_grad():
        for name, p in codec.named_parameters():
            if name.startswith(("encoder.lstm.bias", "encoder.conv_out.b",
                                "quantizer.layers.0.in_proj.b", "semantic.fc_prior.b")):
                p.zero_()
    return codec


def target(b, frames, seed):
    return (np.random.RandomState(seed).randn(b, 1024, frames)).astype(np.float32)


@pytest.fixture(scope="module", params=[True, False], ids=["concat", "no_concat"])
def sem(request):
    """(JAX config, JAX params, port config, port codec, wav, teacher target)."""
    jcfg = semantic_tiny(request.param)
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    codec = spread(TC.init_codec(cfg, generator=torch.Generator().manual_seed(3), device="cpu"))
    wav = (np.random.RandomState(4).randn(B, T) * 0.3).astype(np.float32)
    return jcfg, jax_tree(codec.state_dict()), cfg, codec, wav, target(B, T // HOP, 5)


def _tokenizer(mode):
    def tok(params, jcfg, wav, st):
        return JC.tokenize(params, jcfg, wav, mode=mode, semantic_target=st)
    return tok


JAX_TOKENIZE = {m: _tokenizer(m) for m in MODES}


def _jax_vq_in(params, jcfg, wav, st):
    return JC.semantic_vq_in(params, jcfg, JC.encode(params, jcfg, wav), st)


def _mode_vq_in(mode):
    def vq_in(params, jcfg, wav, st):
        """JAX's quantizer input in a bf16 ``mode``, as its tokenize computes it."""
        if mode == "fast":
            enc16 = {**params, "encoder": JC._cast_tree(params["encoder"], jnp.bfloat16)}
            lat = JC.encode(enc16, jcfg, wav.astype(jnp.bfloat16)).astype(jnp.float32)
        else:
            lat = JC._encode_bigcodec_mixed(params, jcfg, wav)
        with jax.default_matmul_precision("float32"):
            return JC.semantic_vq_in(params, jcfg, lat, st)
    return vq_in


JAX_MODE_VQ_IN = {m: _mode_vq_in(m) for m in ("balanced", "fast")}


def _jax_decode(params, jcfg, codes):
    emb = JC.codes_to_emb(params, jcfg, jnp.moveaxis(codes, 0, -1))
    return JC.decode(params, jcfg, JC.apply_fc_post_a(params, jcfg, emb))


@pytest.mark.parametrize("mode", MODES)
def test_tokenize_modes_match_jax(sem, mode):
    jcfg, params, cfg, codec, wav, st = sem
    want = np.asarray(jax_ref(JAX_TOKENIZE[mode], jcfg)(params, jnp.asarray(wav),
                                                        jnp.asarray(st)))
    with torch.backends.mkldnn.flags(enabled=mode in ("conformant", "high")):
        got = TC.tokenize(codec, torch.from_numpy(wav), mode=mode,
                          semantic_target=torch.from_numpy(st))
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, B, T // HOP)
    assert len(np.unique(want)) > 8  # the tokens compare something
    if mode in EXACT or cfg.train.concat_semantic:
        np.testing.assert_array_equal(got.numpy(), want)
    if mode in EXACT:
        return
    ref = np.asarray(jax_ref(JAX_MODE_VQ_IN[mode], jcfg)(params, jnp.asarray(wav),
                                                         jnp.asarray(st)))
    with torch.backends.mkldnn.flags(enabled=False), torch.no_grad(), TC.full_fp32():
        lat = TC.encode_in_mode(codec.encoder, torch.from_numpy(wav)[:, None, :], mode)
        vq_in = TC.semantic_vq_in(codec, lat, torch.from_numpy(st))
    assert np.abs(vq_in.numpy() - ref).max() <= BF16_LAT_REL * np.abs(ref).max()
    assert (got.numpy() == want).mean() >= BF16_AGREE
    gap, best = top2(codec, ref)
    np.testing.assert_array_equal(best[:, 0], want.reshape(-1))
    off = got.numpy().reshape(-1) != want.reshape(-1)
    np.testing.assert_array_equal(got.numpy().reshape(-1)[off], best[off, 1])
    assert all((gap < g).sum() < NEAR_TIE * gap.size for g in gap[off]), gap[off]


def top2(codec, vq_in):
    """The top-2 gap of the cosine distance and the two nearest codes of each
    frame of ``vq_in`` (B, C, Tf) through the quantizer's first layer, frames
    in (B, Tf) order."""
    layer = codec.quantizer.layers[0]
    with torch.no_grad(), TC.full_fp32():
        z = linear(torch.from_numpy(vq_in).transpose(1, 2), layer.in_proj)
        e = l2_normalize(z.reshape(-1, z.shape[-1]))
        d, idx = (2 - 2 * e @ l2_normalize(layer.codebook).T).topk(2, dim=1, largest=False)
    return (d[:, 1] - d[:, 0]).numpy(), idx.numpy()


def test_vq_input_and_decode_match_jax(sem):
    jcfg, params, cfg, codec, wav, st = sem
    want = np.asarray(jax_ref(_jax_vq_in, jcfg)(params, jnp.asarray(wav), jnp.asarray(st)))
    with torch.no_grad(), TC.full_fp32():
        got = TC.semantic_vq_in(codec, TC.encode(codec, torch.from_numpy(wav)),
                                torch.from_numpy(st))
    np.testing.assert_allclose(got.numpy(), want, rtol=LAT_RTOL, atol=LAT_ATOL)
    codes = np.asarray(jax_ref(JAX_TOKENIZE["conformant"], jcfg)(
        params, jnp.asarray(wav), jnp.asarray(st)))
    want_wav = np.asarray(jax_ref(_jax_decode, jcfg)(params, jnp.asarray(codes)))
    with torch.no_grad(), TC.full_fp32():
        emb = TC.codes_to_emb(codec, torch.from_numpy(codes).permute(1, 2, 0))
        got_wav = TC.decode(codec, TC.apply_fc_post_a(codec, emb))
    np.testing.assert_allclose(got_wav.numpy(), want_wav, rtol=WAV_RTOL, atol=WAV_ATOL)
    # fc_post_a is applied: decoding the bare embeddings gives another waveform
    with torch.no_grad(), TC.full_fp32():
        assert not torch.allclose(TC.decode(codec, emb), got_wav, atol=1e-3)


def test_ragged_paths_match_each_file(sem):
    jcfg, params, cfg, codec, wav, _ = sem
    L = max(LENGTHS)
    rng = np.random.RandomState(6)
    wavs = np.zeros((len(LENGTHS), L), np.float32)
    for i, n in enumerate(LENGTHS):
        wavs[i, :n] = rng.randn(n) * 0.3
    targets = target(len(LENGTHS), L // HOP, 7)
    for i, n in enumerate(LENGTHS):
        targets[i, :, n // HOP:] = 0.0
    lens = torch.tensor(LENGTHS)
    codes = make_ragged_tokenizer(cfg, device="cpu")(codec, torch.from_numpy(wavs), lens,
                                                     torch.from_numpy(targets))
    recon, rcodes = make_ragged_codec(cfg, device="cpu")(codec, torch.from_numpy(wavs), lens,
                                                         torch.from_numpy(targets))
    np.testing.assert_array_equal(rcodes.numpy(), codes.numpy())
    for i, n in enumerate(LENGTHS):
        w, t = torch.from_numpy(wavs[i:i + 1, :n]), torch.from_numpy(targets[i:i + 1, :, :n // HOP])
        own = TC.tokenize(codec, w, semantic_target=t)
        np.testing.assert_array_equal(codes[:, i:i + 1, :n // HOP].numpy(), own.numpy())
        with torch.no_grad():
            out = TC.forward(codec, {"wav": w, "semantic_target": t})
        np.testing.assert_array_equal(out.vq_code.numpy(), own.numpy())
        np.testing.assert_allclose(recon[i, :n].numpy(), out.gen_wav[0, 0].numpy(),
                                   rtol=WAV_RTOL, atol=WAV_ATOL)


def _semantic_reference_dict(tree) -> dict:
    """The SSL heads of ``tree`` under the reference's Lightning names."""
    s = tree["semantic"]

    def t(a):
        return torch.from_numpy(np.array(a, copy=True))

    sd = {}
    for name in ("fc_prior", "fc_post_a", "fc_post_s"):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = t(s[name]["w"]), t(s[name]["b"])
    for ours, theirs in (("encoder", "SemanticEncoder_module"),
                         ("decoder", "SemanticDecoder_module")):
        for leaf, ref in (("initial", "initial_conv"), ("res1", "residual_blocks.1"),
                          ("res2", "residual_blocks.3"), ("final", "final_conv")):
            p = s[ours][leaf]
            sd[f"{theirs}.{ref}.weight"] = t(p["w"])
            if "b" in p:
                sd[f"{theirs}.{ref}.bias"] = t(p["b"])
    return sd


def test_reference_checkpoint_and_jax_run_tokenize_as_jax(sem, tmp_path):
    jcfg, params, cfg, codec, wav, st = sem
    tree = jax.tree.map(np.asarray, params)
    sd = {**reference_state_dict(tree, jcfg), **_semantic_reference_dict(tree)}
    got_sd = TV.convert_codec_state_dict(sd, cfg)
    want_sd = TV.params_from_jax(jax.tree.map(np.asarray, JV.convert_codec_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jcfg)))
    assert got_sd.keys() == want_sd.keys() == codec.state_dict().keys()
    for k in want_sd:
        torch.testing.assert_close(got_sd[k], want_sd[k], rtol=0, atol=0, msg=k)
    want = np.asarray(jax_ref(JAX_TOKENIZE["conformant"], jcfg)(
        params, jnp.asarray(wav), jnp.asarray(st)))
    ref_cfg = PC.from_dict(dataclasses.asdict(jcfg))
    write_reference_run(tmp_path / "ref", tree, jcfg)
    run = tmp_path / "ref"
    torch.save({"state_dict": sd}, run / "pl_log" / "last.ckpt")
    jax_run_to_torch.convert_run(write_jax_run(tmp_path / "jax", tree, jcfg), tmp_path / "conv")
    for path in (tmp_path / "conv", run):
        if path == run:  # the reference's config carries no semantic settings: the run's do
            loaded = TC.Codec(ref_cfg, generator=torch.Generator().manual_seed(0))
            loaded.load_state_dict(got_sd)
        else:
            loaded_cfg, loaded = extract_indices.load_model(path, device="cpu")
            assert loaded_cfg.train.use_semantic and loaded_cfg.train.concat_semantic == \
                jcfg.train.concat_semantic
        got = TC.tokenize(loaded, torch.from_numpy(wav), semantic_target=torch.from_numpy(st))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(path))


def test_concat_needs_the_teacher_and_cannot_stream(sem):
    jcfg, params, cfg, codec, wav, _ = sem
    if not cfg.train.concat_semantic:
        # the latents alone: tokenize needs no teacher, and equals JAX's
        want = np.asarray(jax_ref(JC.tokenize, jcfg)(params, jnp.asarray(wav)))
        np.testing.assert_array_equal(TC.tokenize(codec, torch.from_numpy(wav)).numpy(), want)
        return
    with pytest.raises(ValueError, match="pass semantic_target"):
        TC.tokenize(codec, torch.from_numpy(wav))
    causal = PC.from_dict(dataclasses.asdict(jcfg))
    causal.model.codec_encoder.causal = causal.model.codec_decoder.causal = True
    with pytest.raises(NotImplementedError, match="teacher target per frame"):
        StreamingTokenizer(TC.init_codec(causal, generator=torch.Generator().manual_seed(0),
                                         device="cpu"), chunk_samples=100, device="cpu")
