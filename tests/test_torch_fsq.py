"""The port's FSQ quantizer (``models/quantizers/fsq.py``) and the FSQ
BigCodec (the tiny config of tests/test_train_step.py with
configs/bigcodec_fsq.yaml's levels (4, 4, 4, 8), 512 codes) against the JAX
package's (CPU, seeded numpy inputs; the same weights, the codec's taken
from the port's init through tests/test_torch_conformer_train.py::jax_tree):

- ``fsq_quantize_codes`` (plain and ``preserve_symmetry``) and
  ``fsq_codes_to_indices``: the bounded values within rtol 1e-6 / atol 4
  fp32 ulps of JAX's (``torch.tanh`` and XLA's tanh differ by a few ulps),
  codes and indices equal except where JAX's bounded value lies within
  1e-6 of a .5 rounding boundary;
  inputs placed on the boundaries round half to even in both packages;
  ``fsq_indices_to_codes`` and the implicit codebook equal over all 512
  codes; the noise variant within its bounds;
- ``fsq_apply`` with projections and in the parameterless case (dim ==
  len(levels)), and ``codes_to_emb``, within 1e-6;
- the tiny FSQ BigCodec: tokens byte for byte against JAX ``tokenize`` in
  the conformant and high modes, the bf16 modes (balanced, fast) as
  tests/test_torch_modes.py holds them (latents within 5e-2 x max
  |latent|, 95% of the tokens), decode within rtol 1e-3 / atol 2e-5;
- the ragged tokenizer and codec against each file's own tokenize and
  decode; a causal FSQ codec streamed (``StreamingTokenizer``,
  ``stream_decode``) against its offline tokenize and decode;
- ``cli/extract_indices.py`` as tests/test_extract_fsq.py holds JAX's:
  (T,) int16 files, codes < 512; ``cli/synthesize.py`` on an FSQ run dir;
- a reference FSQ state dict (``decoder.quantizer.project_in`` /
  ``project_out``) converted as JAX converts it;
- ``configs/bigcodec_fsq.yaml`` builds at full width;
- one FSQ training step against ``jit_train_step`` (fp32, metrics within
  rtol 1e-4 / atol 1e-6, updates as tests/test_torch_train.py holds them).
"""
import copy
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu import config as JCF
from audiotokenization_tpu import convert as JV
from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu.models.quantizers import fsq as JF
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch import convert as TV
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.models.quantizers import fsq as TF
from audiotokenization_tpu_torch.models.streaming import StreamingTokenizer, stream_decode
from audiotokenization_tpu_torch.utils.ragged import make_ragged_codec, make_ragged_tokenizer

from test_torch_conformer_train import jax_tree, states
from test_torch_convert import reference_state_dict
from test_torch_train import hold_update, jax_leaves, leaves, smooth

LEVELS = (4, 4, 4, 8)
BOUND_RTOL, BOUND_ULPS = 1e-6, 4
NEAR = 1e-6        # a bounded value this close to a .5 boundary may round either way
EMB_TOL = 1e-6
LAT_REL, AGREE = 5e-2, 0.95
WAV_RTOL, WAV_ATOL = 1e-3, 2e-5
METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-6
HOP = 10
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def no_onednn_one_thread():
    """The bf16 modes with oneDNN off (tests/test_torch_modes.py); one
    intra-op thread for the many small CPU ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.backends.mkldnn.flags(enabled=False):
        yield
    torch.set_num_threads(threads)


def near_boundary(bounded):
    """Where a bounded value lies within NEAR of a .5 rounding boundary."""
    b = np.asarray(bounded, np.float64)
    return np.abs(np.abs(b - np.floor(b)) - 0.5) < NEAR


def jax_bounded(z, levels, preserve_symmetry=False):
    lv = jnp.asarray(np.asarray(levels, np.int32)).astype(jnp.float32)
    z = jnp.asarray(z)
    if preserve_symmetry:
        return np.asarray((2.0 / (lv - 1)) * ((lv - 1) * (jnp.tanh(z) + 1) / 2.0 + 0.5) - 1.0)
    return np.asarray(JF._bound(z, lv))


def boundary_inputs(levels):
    """z (n, d) whose bounded value is, in float64, every k + 0.5 each level
    rounds at: the inverse of the shifted tanh."""
    lv = np.asarray(levels, np.float64)
    half_l = (lv - 1) * 1.001 / 2
    offset = np.where(lv % 2 == 0, 0.5, 0.0)
    shift = np.arctanh(offset / half_l)
    cols = []
    for h, o, s, L in zip(half_l, offset, shift, lv):
        b = np.arange(-(L - 1) / 2 - o, (L - 1) / 2, 1.0) + 0.5
        b = b[np.abs(b + o) < h]
        cols.append(np.arctanh((b + o) / h) - s)
    n = max(len(c) for c in cols)
    return np.stack([np.resize(c, n) for c in cols], axis=1).astype(np.float32)


@pytest.mark.parametrize("preserve_symmetry", [False, True], ids=["bound", "symmetric"])
def test_quantize_codes_and_indices_match_jax(preserve_symmetry):
    rs = np.random.RandomState(0)
    z = np.concatenate([rs.randn(4000, 4) * s for s in (0.3, 1.0, 3.0)]).astype(np.float32)
    want_b = jax_bounded(z, LEVELS, preserve_symmetry)
    want = np.asarray(JF.fsq_quantize_codes(jnp.asarray(z), LEVELS,
                                            preserve_symmetry=preserve_symmetry))
    want_i = np.asarray(JF.fsq_codes_to_indices(jnp.asarray(want), LEVELS))
    got_b = TF.fsq_bounded(torch.from_numpy(z), LEVELS, preserve_symmetry=preserve_symmetry)
    got = TF.fsq_quantize_codes(torch.from_numpy(z), LEVELS, preserve_symmetry=preserve_symmetry)
    got_i = TF.fsq_codes_to_indices(got, LEVELS)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=BOUND_RTOL,
                               atol=BOUND_ULPS * np.spacing(np.float32(4.0)))
    near = near_boundary(want_b)
    ok = ~near
    np.testing.assert_array_equal(got.numpy()[ok], want[ok])
    assert got_i.dtype == torch.int32
    ok = ~near.any(-1)
    np.testing.assert_array_equal(got_i.numpy()[ok], want_i[ok])
    assert len(np.unique(want_i)) > 50


def test_boundaries_round_half_to_even():
    halves = np.array([-3.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    np.testing.assert_array_equal(TF.round_ste(torch.from_numpy(halves)).numpy(),
                                  np.asarray(JF._round_ste(jnp.asarray(halves))))
    np.testing.assert_array_equal(TF.round_ste(torch.from_numpy(halves)).numpy(),
                                  [-4, -2, -2, -0, 0, 2, 2, 4])
    z = boundary_inputs(LEVELS)
    want_b = jax_bounded(z, LEVELS)
    got_b = TF.fsq_bounded(torch.from_numpy(z), LEVELS).numpy()
    assert near_boundary(want_b).mean() > 0.9  # the inputs sit on the boundaries
    np.testing.assert_allclose(got_b, want_b, rtol=BOUND_RTOL,
                               atol=BOUND_ULPS * np.spacing(np.float32(4.0)))
    # each package rounds its own bounded value half to even; where the two
    # bounded values are the same fp32 number the codes are the same
    half = np.asarray(np.asarray(LEVELS) // 2, np.float32)
    got = TF.fsq_quantize_codes(torch.from_numpy(z), LEVELS).numpy()
    want = np.asarray(JF.fsq_quantize_codes(jnp.asarray(z), LEVELS))
    np.testing.assert_array_equal(got, np.round(got_b) / half)
    np.testing.assert_array_equal(want, np.round(want_b) / half)
    same = got_b == want_b
    assert same.any()
    np.testing.assert_array_equal(got[same], want[same])


def test_indices_to_codes_and_codebook_match_jax():
    idx = np.arange(512, dtype=np.int32)
    want = np.asarray(JF.fsq_indices_to_codes(jnp.asarray(idx), LEVELS))
    got = TF.fsq_indices_to_codes(torch.from_numpy(idx), LEVELS).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TF.fsq_implicit_codebook(LEVELS).numpy(),
                                  np.asarray(JF.fsq_implicit_codebook(LEVELS)))
    back = TF.fsq_codes_to_indices(torch.from_numpy(got), LEVELS).numpy()
    np.testing.assert_array_equal(back, idx)  # mixed radix, basis (1, 4, 16, 64)


def test_noise_variant_stays_in_its_bounds():
    z = torch.from_numpy((np.random.RandomState(1).randn(2000, 4) * 2).astype(np.float32))
    b = TF.fsq_bounded(z, LEVELS, generator=torch.Generator().manual_seed(0))
    lv = torch.tensor(LEVELS, dtype=torch.float32)
    assert ((b - torch.tanh(z)).abs() <= 1 / (lv - 1) + 1e-6).all()
    codes = TF.fsq_quantize_codes(z, LEVELS, generator=torch.Generator().manual_seed(0))
    assert (codes.abs() <= 1.0).all() and not torch.equal(codes, TF.fsq_quantize_codes(z, LEVELS))


@pytest.mark.parametrize("dim", [32, 4], ids=["projected", "parameterless"])
def test_fsq_apply_and_codes_to_emb_match_jax(dim):
    jp = jax.tree.map(np.asarray, JF.init_fsq(jax.random.key(2), dim=dim, levels=LEVELS))
    m = TF.FSQ(dim=dim, levels=LEVELS, generator=torch.Generator().manual_seed(0))
    m.load_state_dict(params_from_jax(jp))
    assert (len(list(m.parameters())) == 0) == (dim == len(LEVELS)) == (jp == {})
    scale = 20.0 if dim == 32 else 1.0  # spread the projected values over the levels
    z = (np.random.RandomState(3).randn(2, dim, 50) * scale).astype(np.float32)
    want_q, want_i = JF.fsq_apply(jp, jnp.asarray(z), levels=LEVELS)
    got_q, got_i = TF.fsq_apply(m, torch.from_numpy(z))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert len(np.unique(np.asarray(want_i))) > 20
    np.testing.assert_allclose(got_q.detach().numpy(), np.asarray(want_q), rtol=EMB_TOL,
                               atol=EMB_TOL)
    want_e = JF.fsq_codes_to_emb(want_i, levels=LEVELS, params=jp)
    got_e = TF.fsq_codes_to_emb(m, got_i)
    np.testing.assert_allclose(got_e.detach().numpy(), np.asarray(want_e), rtol=EMB_TOL,
                               atol=EMB_TOL)


# -- the FSQ BigCodec ------------------------------------------------------------

def tiny_fsq(causal=False):
    jcfg = GE._tiny_config()
    jcfg.train.precision = "fp32"
    d = jcfg.model.codec_decoder
    d.fsq, d.fsq_levels, d.codebook_size = True, LEVELS, 512
    for part in (jcfg.model.codec_encoder, d):
        part.causal = causal
    return jcfg


def spread(codec):
    """At init the encoder's biases put every frame on one code: zero them
    (as tests/test_torch_extract.py::spread_codes) and widen project_in so
    the frames spread over the levels. In place."""
    with torch.no_grad():
        for name, p in codec.named_parameters():
            if name.startswith(("encoder.lstm.bias", "encoder.conv_out.b",
                                "quantizer.project_in.b")):
                p.zero_()
        codec.quantizer.project_in.w.mul_(100.0)
    return codec


def build(jcfg, seed):
    """The JAX tree and the port's codec holding the same weights (the
    port's init from ``seed``, spread)."""
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    codec = spread(TC.init_codec(cfg, generator=torch.Generator().manual_seed(seed),
                                 device="cpu"))
    return jax.tree.map(np.asarray, jax_tree(codec.state_dict())), cfg, codec


@pytest.fixture(scope="module")
def fsq_codec():
    jcfg = tiny_fsq()
    return (jcfg, *build(jcfg, 5))


def wav_batch(seed, n=3, t=1600):
    return (np.random.RandomState(seed).randn(n, t) * 0.3).astype(np.float32)


def codes_equal_but_near(got, want, lat, params):
    """Tokens equal except at frames where JAX's bounded value of some dim
    lies within NEAR of a .5 boundary; returns those frames' count."""
    z = np.einsum("bct,dc->btd", lat, params["quantizer"]["project_in"]["w"]) \
        + params["quantizer"]["project_in"]["b"]
    near = near_boundary(jax_bounded(z.astype(np.float32), LEVELS)).any(-1)
    differ = (got != want).reshape(near.shape)
    assert not (differ & ~near).any()
    return int(near.sum())


@pytest.mark.parametrize("mode", ["conformant", "high", "balanced", "fast"])
def test_fsq_codec_tokens_match_jax(fsq_codec, mode):
    jcfg, params, cfg, codec = fsq_codec
    wav = wav_batch(6)
    # JC.tokenize's modes: each mode's encoder, then the fp32 quantizer
    if mode == "fast":
        enc16 = {**params, "encoder": JC._cast_tree(params["encoder"], jnp.bfloat16)}
        want_lat = JC.encode(enc16, jcfg, jnp.asarray(wav, jnp.bfloat16)).astype(jnp.float32)
    elif mode == "balanced":
        want_lat = JC._encode_bigcodec_mixed(params, jcfg, jnp.asarray(wav))
    else:
        with jax.default_matmul_precision("float32"):  # no TF32 on the CPU
            want_lat = JC.encode(params, jcfg, jnp.asarray(wav))
    with jax.default_matmul_precision("float32"):
        want = np.asarray(JC.quantize(params, jcfg, want_lat)[1])
    want_lat = np.asarray(want_lat)
    got = TC.tokenize(codec, torch.from_numpy(wav), mode=mode).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (1, 3, 160)
    assert (got >= 0).all() and (got < 512).all() and len(np.unique(want)) > 20
    if mode in ("conformant", "high"):
        assert codes_equal_but_near(got, want, want_lat, params) == 0
        np.testing.assert_array_equal(got, want)
        return
    lat = TC.encode_in_mode(codec.encoder, torch.from_numpy(wav)[:, None], mode).numpy()
    assert np.abs(lat - want_lat).max() <= LAT_REL * np.abs(want_lat).max()
    assert (got == want).mean() >= AGREE


def port_decode(codec, codes):
    with TC.full_fp32(), torch.no_grad():
        return TC.decode(codec, TC.codes_to_emb(codec, torch.from_numpy(codes).long()
                                                .permute(1, 2, 0))).numpy()


def test_fsq_codec_decode_matches_jax(fsq_codec):
    jcfg, params, cfg, codec = fsq_codec
    codes = np.random.RandomState(7).randint(0, 512, (1, 2, 40)).astype(np.int32)
    emb = JC.codes_to_emb(params, jcfg, jnp.moveaxis(jnp.asarray(codes), 0, -1))
    with TC.full_fp32(), torch.no_grad():
        got_emb = TC.codes_to_emb(codec, torch.from_numpy(codes).long().permute(1, 2, 0))
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(emb), rtol=EMB_TOL, atol=EMB_TOL)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(JC.decode(params, jcfg, emb))
    np.testing.assert_allclose(port_decode(codec, codes), want, rtol=WAV_RTOL, atol=WAV_ATOL)


def test_fsq_ragged_matches_per_file(fsq_codec):
    jcfg, params, cfg, codec = fsq_codec
    lens = [730, 400, 1000]
    wav = wav_batch(8, t=1000)
    for i, n in enumerate(lens):
        wav[i, n:] = 0
    codes = make_ragged_tokenizer(cfg, device="cpu")(codec, torch.from_numpy(wav),
                                                      torch.tensor(lens))
    recon, rcodes = make_ragged_codec(cfg, device="cpu")(codec, torch.from_numpy(wav),
                                                        torch.tensor(lens))
    assert codes.shape == (1, 3, 100)
    for i, n in enumerate(lens):
        own = TC.tokenize(codec, torch.from_numpy(wav[i:i + 1, :n]))
        assert torch.equal(codes[:, i:i + 1, :n // HOP], own)
        assert torch.equal(rcodes[:, i:i + 1, :n // HOP], own)
        want = port_decode(codec, own.numpy())[0, 0]
        np.testing.assert_allclose(recon[i, :n].numpy(), want, rtol=WAV_RTOL, atol=WAV_ATOL)


def test_fsq_streaming_matches_offline():
    jcfg = tiny_fsq(causal=True)
    params, cfg, codec = build(jcfg, 9)
    wav = torch.from_numpy(wav_batch(10, n=2, t=1200))
    chunk = 200
    tok = StreamingTokenizer(codec, chunk_samples=chunk, device="cpu")
    state, pieces = tok.init_state(batch_size=2), []
    for start in range(0, wav.shape[1], chunk):
        codes, state = tok.step(state, wav[:, start:start + chunk])
        pieces.append(codes)
    tail, _ = tok.flush(state)
    assert tail.shape == (1, 2, 0)
    streamed = torch.cat(pieces + [tail], dim=2)
    offline = TC.tokenize(codec, wav)
    assert streamed.shape == offline.shape == (1, 2, 120)
    assert torch.equal(streamed, offline) and len(torch.unique(offline)) > 10
    got = stream_decode(codec, offline, chunk_frames=16, device="cpu").numpy()
    np.testing.assert_allclose(got, port_decode(codec, offline.numpy())[:, 0], rtol=WAV_RTOL,
                               atol=WAV_ATOL)


def test_fsq_extract_and_synthesize_cli(fsq_codec, tmp_path):
    from audiotokenization_tpu_torch.cli import extract_indices, synthesize
    from audiotokenization_tpu_torch.data.audio_io import read_wav, write_wav

    jcfg, params, cfg, codec = fsq_codec
    run = tmp_path / "run"
    (run / "ckpt" / "0").mkdir(parents=True)
    PC.save_config(cfg, run / "config.json")
    torch.save({"step": 0, "gen": codec.state_dict()}, run / "ckpt" / "0" / "state.pt")
    root = tmp_path / "data" / "LibriSpeech" / "test-clean" / "1" / "2"
    root.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i, n in enumerate((1500, 1234)):
        write_wav(root / f"1-2-{i:04d}.wav", (rng.randn(n) * 0.3).astype(np.float32), 16000)
    extract_indices.main(["--dataset_root", str(tmp_path / "data"), "--save_path", str(run),
                          "--dataset_path", "LibriSpeech", "--ext_audio", ".wav",
                          "--subsets", "test-clean", "--batch_size", "2", "--device", "cpu"])
    for i, n in enumerate((1500, 1234)):
        out = np.load(run / "extracted_indices" / "test-clean" / "1" / "2" / f"1-2-{i:04d}.npy")
        assert out.dtype == np.int16 and out.shape == (-(-n // HOP),)
        assert (out >= 0).all() and (out < 512).all()
        w = read_wav(root / f"1-2-{i:04d}.wav")[0][0]
        want = TC.tokenize(codec, torch.from_numpy(np.pad(w, (0, -n % HOP)))[None])
        np.testing.assert_array_equal(out, want.numpy()[0, 0])
    wav = synthesize.main(["--codec_ckpt", str(run), "--random", "--seconds", "0.05",
                           "--num_samples", "2", "--out_dir", str(tmp_path / "synth"),
                           "--device", "cpu"])
    tokens = np.load(tmp_path / "synth" / "tokens.npy").astype(np.int32)
    assert tokens.shape == (2, 80) and (tokens < 512).all()
    from audiotokenization_tpu_torch.ops.conv import fold_weight_norm
    folded = fold_weight_norm(copy.deepcopy(codec))
    np.testing.assert_allclose(wav, port_decode(folded, tokens[None])[:, 0], rtol=WAV_RTOL,
                               atol=WAV_ATOL)


def test_reference_fsq_state_dict_converts_as_jax(fsq_codec):
    jcfg, params, cfg, codec = fsq_codec
    vq_cfg = copy.deepcopy(jcfg)
    vq_cfg.model.codec_decoder.vq_num_quantizers = 0  # the codec's keys only
    sd = reference_state_dict({**params, "quantizer": {"layers": []}}, vq_cfg)
    for name in ("project_in", "project_out"):
        for ours, theirs in (("w", "weight"), ("b", "bias")):
            sd[f"decoder.quantizer.{name}.{theirs}"] = torch.from_numpy(
                params["quantizer"][name][ours].copy())
    want = params_from_jax(jax.tree.map(
        np.asarray, JV.convert_codec_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg)))
    got = TV.convert_codec_state_dict(sd, cfg)
    assert got.keys() == want.keys() == codec.state_dict().keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the parameterless FSQ (latent width == len(levels)) converts to no keys
    assert TV.convert_fsq({}) == {}


def test_full_width_fsq_config_builds():
    jcfg = JCF.load_config(ROOT / "configs" / "bigcodec_fsq.yaml")
    cfg = PC.load_config(ROOT / "configs" / "bigcodec_fsq.yaml")
    assert PC.to_dict(cfg) == dataclasses.asdict(jcfg)
    codec = TC.Codec(cfg, generator=torch.Generator().manual_seed(0))
    assert isinstance(codec.quantizer, TF.FSQ) and PC.num_codebooks(cfg) == 1
    assert tuple(codec.quantizer.project_in.w.shape) == (4, 1024)
    assert all(u.fused for b in codec.encoder.blocks for u in b.units)
    flagship = TC.Codec(PC.Config(), generator=torch.Generator().manual_seed(0))
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    assert count(codec.encoder) + count(codec.decoder) == \
        count(flagship.encoder) + count(flagship.decoder)
    assert count(codec.quantizer) == 2 * 4 * 1024 + 4 + 1024


def test_fsq_train_step_matches_jax(fsq_codec):
    """One fp32 step from the same weights (AdamW eps 1, no warmup): metrics,
    the 512-bin codebook histogram and the updates."""
    from audiotokenization_tpu.train.step import make_train_step as jax_make_train_step
    from audiotokenization_tpu_torch.train.step import make_train_step

    jcfg = smooth(tiny_fsq())
    cfg, state, jstate = states(jcfg, 4, edit=spread)
    wav = wav_batch(11, n=2, t=800)
    jb = jax_leaves(jstate)
    jstate2, jm = jax.jit(jax_make_train_step(jcfg))(jstate, {"wav": jnp.asarray(wav)})
    ja = jax_leaves(jstate2)
    pb = leaves(state)
    pm = make_train_step(cfg, device="cpu")(state, {"wav": torch.from_numpy(wav)})
    pa = leaves(state)
    assert set(pm) == {k for k in jm} and "moe_load_balance" not in pm
    for key in ("disc_loss", "real_loss", "fake_loss", "gen_loss", "mel_loss", "adv_loss",
                "fm_loss", "vq_loss", "gen_lr"):
        np.testing.assert_allclose(np.asarray(pm[key]), np.asarray(jm[key]), rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL, err_msg=key)
    assert float(pm["vq_loss"]) == 0.0
    assert pm["codebook_hist"].shape == (512,)
    np.testing.assert_array_equal(pm["codebook_hist"].numpy(), np.asarray(jm["codebook_hist"]))
    assert set(pa) == set(ja)
    for name in ja:
        hold_update(name, (pb[name], pa[name]), (jb[name], ja[name]))
