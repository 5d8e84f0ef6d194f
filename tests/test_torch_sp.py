"""The port's sequence-parallel tokenizer and synthesizer
(``audiotokenization_tpu_torch/parallel/sp.py``) against the JAX
package's on the conftest's virtual CPU devices (the cases of
tests/test_sp_tokenize.py), the port on ``[cpu] * n``, the same weights in
both (the port's init from a seed, the JAX tree built from it), at n 2
and 4:

- exact tokens on the tiny config and its causal and anti-aliased
  variants, an even and an uneven length in one chunk bucket: equal to
  JAX's ``make_sp_tokenizer`` and to the port's one-device ``tokenize``,
  the buckets JAX's; K1 once and K2 once per unit a shard, every K2 input
  contiguous (K2 takes only contiguous tensors on the card);
- ``lstm="reset"`` (BigCodec and the Conformer) against JAX's reset
  tokens, and ``mode="fast"`` against JAX's fast SP, each also against the
  one-device tokens as JAX's tests hold them (at least 90% agreement,
  70% for the Conformer's windowed attention);
- synthesis against JAX's ``make_sp_synthesizer`` and the port's
  one-device decode within rtol 1e-3 / atol 2e-5 (the repo's waveform
  tolerance), plain and anti-aliased, an even and an uneven frame count;
- a wav -> SP tokens -> SP waveform round trip against JAX's decode of the
  tokens;
- each refusal with JAX's exception and message; the entry points default
  to the card.

The JAX references run once per config, device count and chunk bucket.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu.parallel import sp as JSP
from audiotokenization_tpu.parallel.mesh import make_data_mesh
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.models import bigcodec
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.models.quantizers import factorized_vq
from audiotokenization_tpu_torch.parallel import sp as TSP

from test_torch_conformer_train import jax_tree

WAV_RTOL, WAV_ATOL = 1e-3, 2e-5
HOP = 10  # the tiny config's
QUANTUM = 400 / 16000  # a 400-sample chunk quantum: both lengths below share a bucket
LENGTHS = (3200, 3070)  # an even length and an uneven one (307 frames)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny(variant="plain"):
    jcfg = GE._tiny_config()
    jcfg.train.precision = "fp32"
    e, d = jcfg.model.codec_encoder, jcfg.model.codec_decoder
    if variant == "causal":  # the encoder only: SP synthesis refuses a causal decoder
        e.causal = True
    elif variant == "antialias":
        e.antialias = d.antialias = True
    elif variant == "conformer":  # tests/test_sp_tokenize.py::test_sp_reset_mode_conformer
        e.type, e.hop_length, e.n_fft, e.window_size = "conformer_stft", 10, 40, 40
        e.dim, e.n_layers, e.n_head, e.out_channels = 16, 1, 2, 32
    return jcfg


def spread_codes(codec):
    """Zero the encoder's LSTM and output biases and the VQ's input
    projection bias: at init they dominate the tiny BigCodec's latents and
    nearly every frame takes one code (tests/test_torch_extract.py::
    spread_codes); without them the frames spread over the codebook."""
    enc = codec.encoder
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if name.startswith("lstm.bias") or name == "conv_out.b":
                p.zero_()
        for layer in getattr(codec.quantizer, "layers", []):
            layer.in_proj.b.zero_()


def build(jcfg, seed=0):
    """The JAX tree and the port's codec holding the same weights."""
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    codec = TC.init_codec(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    if jcfg.model.codec_encoder.type == "bigcodec":
        spread_codes(codec)
    return jax_tree(codec.state_dict()), codec


def mesh(n):
    return make_data_mesh(jax.devices()[:n])


def wav(seed, T):
    return (np.random.RandomState(seed).randn(T) * 0.1).astype(np.float32)


def one_device_tokens(codec, w):
    return TC.tokenize(codec, torch.from_numpy(w)[None])[:, 0].numpy()


def one_device_decode(codec, codes):
    with torch.no_grad(), TC.full_fp32():
        emb = TC.apply_fc_post_a(codec, TC.codes_to_emb(codec, torch.as_tensor(codes).t()[None]))
        return TC.decode(codec, emb)[0, 0].numpy()


@pytest.fixture
def launches(monkeypatch):
    """K1 and K2 calls (the kernels' wrappers, which take their plain
    versions on the CPU), each K2 input checked contiguous."""
    count = {"k1": 0, "k2": 0, "noncontiguous": 0}
    k1, k2 = factorized_vq.vq_argmin, bigcodec.fused_residual_unit

    def counted_k1(*args, **kw):
        count["k1"] += 1
        return k1(*args, **kw)

    def counted_k2(x, *args, **kw):
        count["k2"] += 1
        count["noncontiguous"] += not all(t.is_contiguous() for t in (x, *args))
        return k2(x, *args, **kw)

    monkeypatch.setattr(factorized_vq, "vq_argmin", counted_k1)
    monkeypatch.setattr(bigcodec, "fused_residual_unit", counted_k2)
    return count


def units(cfg, side="codec_encoder"):
    part = getattr(cfg.model, side)
    fused = not (part.causal or part.antialias)
    return len(part.up_ratios) * len(part.dilations) if fused else 0


@pytest.mark.parametrize("variant,n", [("plain", 2), ("plain", 4), ("causal", 4),
                                       ("antialias", 2), ("antialias", 4)])
def test_sp_exact_tokens_match_jax_and_one_device(variant, n, launches):
    jcfg = tiny(variant)
    tree, codec = build(jcfg, seed=n)
    jtok = JSP.make_sp_tokenizer(jcfg, mesh(n), chunk_quantum_seconds=QUANTUM)
    tok = TSP.make_sp_tokenizer(codec.cfg, ["cpu"] * n, chunk_quantum_seconds=QUANTUM,
                                device="cpu")
    for i, T in enumerate(LENGTHS):
        w = wav(10 * n + i, T)
        want = np.asarray(jtok(tree, jnp.asarray(w)))
        launches.update(k1=0, k2=0)
        got = tok(codec, w).numpy()
        assert (launches["k1"], launches["k2"]) == (n, n * units(codec.cfg))
        assert got.shape == want.shape == (1, T // HOP)
        np.testing.assert_array_equal(got, want, err_msg=f"T={T}")
        np.testing.assert_array_equal(got, one_device_tokens(codec, w), err_msg=f"T={T}")
        assert len(np.unique(got)) > 16  # the frames spread over the 64 codes
    assert launches["noncontiguous"] == 0
    assert sorted(tok.buckets) == sorted(jtok.cache) and len(tok.buckets) == 1


def test_sp_reset_and_fast_match_jax_modes():
    """reset: each window tokenized alone; fast: the exact machinery on bf16
    copies (oneDNN off: this CPU build's oneDNN bf16 convs are wrong where
    the kernel is wider than the padded input)."""
    n, T = 4, 3200
    jcfg = tiny()
    tree, codec = build(jcfg, seed=3)
    w = wav(3, T)
    full = one_device_tokens(codec, w)
    want = np.asarray(JSP.make_sp_tokenizer(jcfg, mesh(n), lstm="reset")(tree, jnp.asarray(w)))
    got = TSP.make_sp_tokenizer(codec.cfg, ["cpu"] * n, lstm="reset", device="cpu")(
        codec, w).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == full).mean() > 0.9
    want = np.asarray(JSP.make_sp_tokenizer(jcfg, mesh(n), mode="fast")(tree, jnp.asarray(w)))
    with torch.backends.mkldnn.flags(enabled=False):
        got = TSP.make_sp_tokenizer(codec.cfg, ["cpu"] * n, mode="fast", device="cpu")(
            codec, w).numpy()
    assert got.shape == want.shape == full.shape
    assert (got == want).mean() > 0.9 and (got == full).mean() > 0.9


def test_sp_reset_conformer_matches_jax():
    n, T = 4, 3200
    jcfg = tiny("conformer")
    tree, codec = build(jcfg, seed=9)
    w = wav(9, T)
    want = np.asarray(JSP.make_sp_tokenizer(jcfg, mesh(n), lstm="reset")(tree, jnp.asarray(w)))
    got = TSP.make_sp_tokenizer(codec.cfg, ["cpu"] * n, lstm="reset", device="cpu")(
        codec, w).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == one_device_tokens(codec, w)).mean() > 0.7  # attention is global


@pytest.mark.parametrize("variant,n", [("plain", 4), ("antialias", 2)])
def test_sp_synthesize_matches_jax_and_one_device(variant, n, launches):
    jcfg = tiny(variant)
    tree, codec = build(jcfg, seed=6 + n)
    rng = np.random.RandomState(6)
    jsyn = JSP.make_sp_synthesizer(jcfg, mesh(n), chunk_quantum_frames=30)
    syn = TSP.make_sp_synthesizer(codec.cfg, ["cpu"] * n, chunk_quantum_frames=30, device="cpu")
    for tf in (n * 30, n * 30 - 17):
        codes = rng.randint(0, 64, (1, tf)).astype(np.int32)
        want = np.asarray(jsyn(tree, jnp.asarray(codes)))
        launches.update(k1=0, k2=0)
        got = syn(codec, torch.from_numpy(codes)).numpy()
        assert (launches["k1"], launches["k2"]) == (0, n * units(codec.cfg, "codec_decoder"))
        assert got.shape == want.shape == (tf * HOP,)
        np.testing.assert_allclose(got, want, rtol=WAV_RTOL, atol=WAV_ATOL, err_msg=f"tf={tf}")
        np.testing.assert_allclose(got, one_device_decode(codec, codes), rtol=WAV_RTOL,
                                   atol=WAV_ATOL, err_msg=f"tf={tf}")
    assert launches["noncontiguous"] == 0
    assert sorted(syn.buckets) == sorted(jsyn.cache) and len(syn.buckets) == 1


def test_sp_round_trip_tokens_to_wav():
    n = 4
    jcfg = tiny()
    tree, codec = build(jcfg, seed=8)
    codes = TSP.tokenize_sequence_parallel(codec, wav(8, 3200), ["cpu"] * n, device="cpu")
    got = TSP.make_sp_synthesizer(codec.cfg, ["cpu"] * n, chunk_quantum_frames=40,
                                  device="cpu")(codec, codes).numpy()
    z = JC.codes_to_emb(tree, jcfg, jnp.asarray(codes.numpy().T)[None])
    want = np.asarray(jax.jit(lambda p, z: JC.decode(p, jcfg, z))(tree, z))[0, 0]
    assert got.shape == want.shape == (3200,)
    np.testing.assert_allclose(got, want, rtol=WAV_RTOL, atol=WAV_ATOL)


def _same_refusal(jax_call, port_call, exc):
    with pytest.raises(exc) as want:
        jax_call()
    with pytest.raises(exc) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_sp_refusals_match_jax():
    n = 2
    jcfg = tiny()
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    _same_refusal(lambda: JSP.make_sp_tokenizer(jcfg, mesh(n), mode="balanced"),
                  lambda: TSP.make_sp_tokenizer(cfg, ["cpu"] * n, mode="balanced"), ValueError)
    conf = tiny("conformer")
    _same_refusal(lambda: JSP.make_sp_tokenizer(conf, mesh(n)),
                  lambda: TSP.make_sp_tokenizer(PC.from_dict(dataclasses.asdict(conf)),
                                                ["cpu"] * n), NotImplementedError)
    bidir = tiny()
    bidir.model.codec_encoder.rnn_bidirectional = True
    tree, codec = build(bidir)
    w = wav(0, 3200)
    _same_refusal(lambda: JSP.make_sp_tokenizer(bidir, mesh(n))(tree, jnp.asarray(w)),
                  lambda: TSP.make_sp_tokenizer(codec.cfg, ["cpu"] * n)(codec, w),
                  NotImplementedError)
    # the synthesizer: a Conformer decoder, a causal or bidirectional one,
    # stride-1 up_ratios
    for edit in ("conformer", "causal", "bidirectional", "stride1"):
        j = tiny()
        d = j.model.codec_decoder
        if edit == "conformer":
            d.type = "conformer_istft"
        elif edit == "causal":
            d.causal = True
        elif edit == "bidirectional":
            d.rnn_bidirectional = True
        else:
            d.up_ratios = (5, 1, 2)
        _same_refusal(lambda: JSP.make_sp_synthesizer(j, mesh(n)),
                      lambda: TSP.make_sp_synthesizer(PC.from_dict(dataclasses.asdict(j)),
                                                      ["cpu"] * n), NotImplementedError)
    # a chunk shorter than the first block's halo (10 frames at stride 5)
    tree, codec = build(jcfg)
    x = np.zeros((1, 16, 4), np.float32)
    kw = dict(stride=5, dilations=(1, 3, 9), antialias=False, L=4, S_out=5, tm=8)
    _same_refusal(
        lambda: JSP._decoder_block_sp(tree["decoder"]["blocks"][0], jnp.asarray(x), my=0,
                                      axis_name="data", n=n, **kw),
        lambda: TSP._decoder_block_sp([codec.decoder.blocks[0]] * n,
                                      [torch.from_numpy(x)] * n, **kw), ValueError)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSP.make_sp_tokenizer(cfg)  # the default is every visible card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSP.make_sp_synthesizer(cfg)
