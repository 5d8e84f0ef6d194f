"""The port's SSL upstreams (``models/wavlm.py``, ``models/wav2vec2.py``)
against the JAX package's, both converting the same transformers state dict
(random init, at the tiny sizes of tests/test_wavlm.py and
tests/test_wav2vec2.py; no download):

- every hidden state of WavLM, wav2vec2, HuBERT and UniSpeech-SAT, each in
  the group-norm / post-LN (base) and the layer-norm / stable pre-LN
  (large) layout, within rtol 2e-3 / atol 3e-4 (those tests' tolerance;
  ``-s`` prints the worst error against JAX and against transformers);
- the relative-position buckets equal to JAX's as integers over every
  offset of T up to 1,600 (320 buckets, max distance 800), and the cached
  index at several T;
- ``load_ssl_upstream`` from the state dict alone against JAX's (the
  inferred config equal, the hidden states within the same tolerance);
  the state dict in both
  weight-norm layouts (``parametrizations.weight.original0/1`` and
  ``weight_g`` / ``weight_v``) converting to the same tensors;
- ``output_layer`` equal to that entry of the full list, computing no layer
  past it;
- ``load_ssl_upstream`` refusing an unknown family, on the card by
  default.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.models import wav2vec2 as JV
from audiotokenization_tpu.models import wavlm as JW
from audiotokenization_tpu.models.ecapa_tdnn import ssl_weighted_features as jax_weighted
from audiotokenization_tpu_torch.models import ecapa_tdnn as TE
from audiotokenization_tpu_torch.models import wav2vec2 as TV
from audiotokenization_tpu_torch.models import wavlm as TW

RTOL, ATOL = 2e-3, 3e-4
SMALL = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
             intermediate_size=128, conv_dim=(32, 32, 32), conv_kernel=(10, 3, 2),
             conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4)
NO_DROP = dict(output_hidden_states=True, layerdrop=0.0, hidden_dropout=0.0,
               attention_dropout=0.0, feat_proj_dropout=0.0, activation_dropout=0.0)
CASES = [(f, n) for f in ("wavlm", "wav2vec2", "hubert", "unispeech_sat")
         for n in ("group", "layer")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def hf_model(family, norm):
    import transformers as T

    cls = {"wavlm": (T.WavLMConfig, T.WavLMModel),
           "wav2vec2": (T.Wav2Vec2Config, T.Wav2Vec2Model),
           "hubert": (T.HubertConfig, T.HubertModel),
           "unispeech_sat": (T.UniSpeechSatConfig, T.UniSpeechSatModel)}[family]
    shape = dict(SMALL, feat_extract_norm=norm, conv_bias=(norm == "layer"),
                 do_stable_layer_norm=(norm == "layer"))
    if family == "wavlm":
        shape.update(num_buckets=40, max_bucket_distance=100)
    torch.manual_seed(0)
    model = cls[1](cls[0](**shape, **NO_DROP)).eval()
    jcfg = (JW.WavLMConfig if family == "wavlm" else JV.Wav2Vec2Config)(**shape)
    return model, jcfg


def state_dict(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def wav(b=2, t=2000, seed=0):
    return (np.random.RandomState(seed).randn(b, t) * 0.1).astype(np.float32)


def jax_apply(family, sd, jcfg, x):
    if family == "wavlm":
        return jax.jit(lambda p, w: JW.wavlm_apply(p, jcfg, w))(JW.convert_wavlm(sd, jcfg), x)
    return jax.jit(lambda p, w: JV.wav2vec2_apply(p, jcfg, w))(JV.convert_wav2vec2(sd, jcfg), x)


@pytest.fixture(scope="module")
def built():
    """Per case: the HF model, its state dict, JAX's config and hidden
    states, and the port's model."""
    out = {}
    x = wav()
    for family, norm in CASES:
        model, jcfg = hf_model(family, norm)
        sd = state_dict(model)
        with torch.no_grad():
            hf = [h.numpy() for h in model(torch.from_numpy(x)).hidden_states]
        want = [np.asarray(h) for h in jax_apply(family, sd, jcfg, jnp.asarray(x))]
        cfg = (TW.WavLMConfig if family == "wavlm" else TV.Wav2Vec2Config)(**vars(jcfg))
        gated = family == "wavlm"
        model = TW.load_ssl_model(TW.convert_wavlm(sd, cfg, _family=family if gated else
                                                   "wav2vec2"), cfg, gated=gated, device="cpu")
        out[family, norm] = dict(sd=sd, jcfg=jcfg, hf=hf, want=want, model=model)
    return out


@pytest.mark.parametrize("family,norm", CASES)
def test_hidden_states_match_jax(family, norm, built):
    case = built[family, norm]
    with torch.no_grad():
        got = [h.numpy() for h in TW.encoder_apply(case["model"], torch.from_numpy(wav()))]
    assert len(got) == len(case["want"]) == 4
    worst_jax = max(float(np.abs(g - w).max()) for g, w in zip(got, case["want"]))
    worst_hf = max(float(np.abs(g - h).max()) for g, h in zip(got, case["hf"]))
    print(f"\n{family}/{norm}: max |port - jax| {worst_jax:.3g}, "
          f"max |port - transformers| {worst_hf:.3g}")
    for i, (g, w) in enumerate(zip(got, case["want"])):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"hidden {i}")


@pytest.mark.parametrize("family,norm", CASES)
def test_load_ssl_upstream_matches_jax(family, norm, built):
    """The entry point from the state dict alone: the inferred config
    (the published max bucket distance, 800) equal to JAX's, and the
    hidden states of its ssl_fn against JAX's load_ssl_upstream."""
    case = built[family, norm]
    kw = dict(num_attention_heads=4, conv_stride=(5, 2, 2))
    jfn, jcfg = JV.load_ssl_upstream(case["sd"], family, **kw)
    fn, cfg = TV.load_ssl_upstream(case["sd"], family, device="cpu", **kw)
    assert type(cfg).__name__ == type(jcfg).__name__ and vars(cfg) == vars(jcfg)
    x = wav(1, 2400, seed=1)
    want = jax.jit(jfn)(jnp.asarray(x))
    with torch.no_grad():
        got = fn(torch.from_numpy(x))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=f"hidden {i}")
    # the config from torch tensors too; WavLM's heads from rel_attn_embed unforced
    sd_t = {k: torch.from_numpy(v) for k, v in case["sd"].items()}
    assert vars(TV.infer_config_from_sd(sd_t, family, **kw)) == vars(jcfg)
    if family == "wavlm":
        assert TV.infer_config_from_sd(case["sd"], family,
                                       conv_stride=(5, 2, 2)).num_attention_heads == 4


def test_buckets_equal_jax():
    """Every offset of a 1,600-frame input (32 s) and the cached index at
    several lengths, at WavLM's 320 buckets and max distance 800."""
    rel = np.arange(-1599, 1600)
    want = JW._relative_buckets(rel, num_buckets=320, max_distance=800)
    got = TW._relative_buckets(rel, num_buckets=320, max_distance=800)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # every bucket is reached but 160: offset 0 falls on the non-positive half
    assert set(np.unique(got)) == set(range(320)) - {160}
    cfg = JW.WavLMConfig()
    embed = np.arange(320 * 2, dtype=np.float32).reshape(320, 2)
    for T in (1, 2, 49, 500, 1499, 1600):
        idx = TW._bucket_index(T, 320, 800, torch.device("cpu"))
        ref = np.asarray(JW._position_bias(jnp.asarray(embed), T, cfg))[0] / 2
        assert idx.dtype == torch.int64 and np.array_equal(idx.numpy(), ref.astype(np.int64)), T


def test_weight_norm_layouts_convert_alike(built):
    case = built["wavlm", "layer"]
    sd = case["sd"]
    pc = "encoder.pos_conv_embed.conv"
    assert f"{pc}.parametrizations.weight.original0" in sd
    old = {k: v for k, v in sd.items() if ".parametrizations." not in k}
    old[f"{pc}.weight_g"] = sd[f"{pc}.parametrizations.weight.original0"]
    old[f"{pc}.weight_v"] = sd[f"{pc}.parametrizations.weight.original1"]
    cfg = case["model"].cfg
    a, b = TW.convert_wavlm(sd, cfg), TW.convert_wavlm(old, cfg)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # the folded weight is JAX's, bit for bit, from either layout
    jw = np.asarray(JW.convert_wavlm(old, case["jcfg"])["pos_conv"]["w"])
    assert np.array_equal(b["pos_conv.w"].numpy(), jw)
    assert vars(TV.infer_config_from_sd(old, "wavlm", conv_stride=(5, 2, 2))) == vars(
        TV.infer_config_from_sd(sd, "wavlm", conv_stride=(5, 2, 2)))


@pytest.mark.parametrize("family,norm", [("wavlm", "layer"), ("wav2vec2", "group")])
def test_output_layer(family, norm, built):
    case = built[family, norm]
    model = case["model"]
    apply = TW.wavlm_apply if family == "wavlm" else TV.wav2vec2_apply
    x = torch.from_numpy(wav(1, 2000, seed=2))
    with torch.no_grad():
        full = apply(model, x)
        for layer in range(4):
            assert torch.equal(apply(model, x, output_layer=layer), full[layer]), layer
    seen = []
    orig = TW._feed_forward
    TW._feed_forward = lambda p, h: (seen.append(p), orig(p, h))[1]
    try:
        with torch.no_grad():
            apply(model, x, output_layer=1)
    finally:
        TW._feed_forward = orig
    assert seen == [model.layers[0].ffn]
    with pytest.raises(ValueError):
        (TV.wav2vec2_apply if family == "wavlm" else TW.wavlm_apply)(model, x)


def test_ecapa_ssl_frontend_matches_jax(built):
    case = built["hubert", "group"]
    fw = np.array([0.5, -0.2, 0.1, 1.0], np.float32)
    want = np.asarray(jax_weighted(case["want"], jnp.asarray(fw)))
    with torch.no_grad():
        got = TE.extract_features(torch.from_numpy(wav()), feat_type="ssl",
                                  ssl_fn=TW.make_ssl_fn(case["model"]),
                                  feature_weight=torch.from_numpy(fw)).numpy()
    assert got.shape == (2, 64, want.shape[-1])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_load_ssl_upstream_refuses_and_defaults_to_card(built):
    sd = built["hubert", "group"]["sd"]
    with pytest.raises(ValueError, match="unknown SSL family"):
        TV.load_ssl_upstream(sd, "data2vec", device="cpu")
    with pytest.raises(ValueError, match="conv_stride"):
        TV.infer_config_from_sd(sd, "hubert")  # a 3-stage extractor has no canonical stride
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TV.load_ssl_upstream(sd, "hubert", conv_stride=(5, 2, 2))
