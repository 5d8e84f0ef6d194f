"""The port's STFT, GAN losses and discriminators against the JAX package on
the same numpy inputs (and, for the discriminators, the same weights, through
convert.params_from_jax). Tolerance: rtol 1e-4 / atol 1e-5 throughout."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu.config import Config as JaxConfig
from audiotokenization_tpu.losses import gan as JG
from audiotokenization_tpu.losses.mel import MultiResolutionMelLoss as JaxMel
from audiotokenization_tpu.losses.stft_loss import multi_resolution_stft_loss as jax_stft_loss
from audiotokenization_tpu.models import discriminators as JD
from audiotokenization_tpu.ops import stft as JS
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.losses import gan as TG
from audiotokenization_tpu_torch.losses.mel import MultiResolutionMelLoss
from audiotokenization_tpu_torch.losses.stft_loss import multi_resolution_stft_loss
from audiotokenization_tpu_torch.models import discriminators as TD
from audiotokenization_tpu_torch.ops import stft as TS

RTOL, ATOL = 1e-4, 1e-5


def close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def wav(seed, shape, scale=0.1):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops: as fast alone, and
    no oversubscription of the cores that parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_init_disc(jcfg, seed):
    """The discriminators' part of the JAX train state (``init_train_state``'s
    ``disc_params``): MPD and spectrogram discriminator."""
    m = jcfg.model
    sp = m.mstft.stft_params

    def init(key):
        k1, k2 = jax.random.split(key)
        return {"mpd": JD.init_mpd(k1, periods=tuple(m.mpd.periods), channels=m.mpd.channels,
                                   channel_increasing_factor=m.mpd.channel_increasing_factor,
                                   max_downsample_channels=m.mpd.max_downsample_channels),
                "spec": JD.init_spec_discriminator(
                    k2, n_resolutions=len(sp.fft_sizes), channels=m.mstft.channels,
                    max_downsample_channels=m.mstft.max_downsample_channels,
                    downsample_scales=tuple(m.mstft.downsample_scales))}

    params = jax.jit(init)(jax.random.key(seed))
    return params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tiny_disc():
    """The tiny config's JAX discriminators, with their numpy tree."""
    jcfg = GE._tiny_config()
    return (jcfg, *_jax_init_disc(jcfg, 0))


@pytest.mark.parametrize("n_fft,hop,win,T", [(128, 32, 128, 1000), (256, 64, 200, 1000),
                                             (2048, 512, 2048, 800), (64, 16, 64, 33)])
def test_stft_matches_jax(n_fft, hop, win, T):
    """Includes a window shorter than n_fft and reflect pads longer than the signal."""
    x = wav(0, (2, T))
    ref = JS.stft(jnp.asarray(x), n_fft=n_fft, hop_length=hop, win_length=win)
    got = TS.stft(torch.from_numpy(x), n_fft=n_fft, hop_length=hop, win_length=win)
    assert got.shape == ref.shape
    close(got.real, np.real(ref))
    close(got.imag, np.imag(ref))


@pytest.mark.parametrize("n_fft,hop,win", [(128, 32, 128), (1024, 256, 1024)])
def test_stft_magnitude_matches_jax(n_fft, hop, win):
    x = wav(1, (3, 4000))
    ref = JS.stft_magnitude(jnp.asarray(x), n_fft=n_fft, hop_length=hop, win_length=win)
    close(TS.stft_magnitude(torch.from_numpy(x), n_fft=n_fft, hop_length=hop, win_length=win), ref)


def test_reflect_pad_is_numpys():
    x = np.arange(5, dtype=np.float32)[None]
    for pad in (1, 4, 9, 23):
        np.testing.assert_array_equal(TS.reflect_pad(torch.from_numpy(x), pad).numpy(),
                                      np.pad(x, ((0, 0), (pad, pad)), mode="reflect"))


@pytest.mark.parametrize("n_fft,n_mels", [(32, 5), (512, 80), (2048, 320)])
def test_mel_filterbank_matches_jax(n_fft, n_mels):
    ref = JS.mel_filterbank(sample_rate=16000, n_fft=n_fft, n_mels=n_mels)
    np.testing.assert_allclose(TS.mel_filterbank(sample_rate=16000, n_fft=n_fft, n_mels=n_mels),
                               np.asarray(ref), rtol=1e-6, atol=1e-9)


def test_mel_loss_and_its_gradient_match_jax_with_a_zero_frame():
    """The generated waveform holds an exactly-zero stretch (zero STFT bins at
    the short windows), where the gradient guard keeps the gradient finite."""
    x, y = wav(2, (2, 3000)), wav(3, (2, 3000))
    x[:, 1000:1600] = 0.0
    jl = JaxMel(sample_rate=16000)
    ref, ref_grad = jax.jit(jax.value_and_grad(jl))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = MultiResolutionMelLoss(sample_rate=16000)(xt, torch.from_numpy(y))
    (grad,) = torch.autograd.grad(got, xt)
    close(got, ref)
    assert torch.isfinite(grad).all()
    scale = float(np.abs(np.asarray(ref_grad)).max())
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=RTOL, atol=ATOL * scale)


def _features(seed, n_sub=3):
    rng = np.random.RandomState(seed)
    return [[rng.randn(2, 4, 7).astype(np.float32), rng.randn(2, 3, 5, 2).astype(np.float32),
             rng.randn(2, 11).astype(np.float32)] for _ in range(n_sub)]


def _both(feats):
    return ([[jnp.asarray(t) for t in sub] for sub in feats],
            [[torch.from_numpy(t) for t in sub] for sub in feats])


def test_gan_losses_match_jax():
    (jr, tr), (jf, tf) = _both(_features(4)), _both(_features(5))
    for got, ref in zip(TG.disc_loss(tr, tf), JG.disc_loss(jr, jf)):
        close(got, ref)
    close(TG.gen_adv_loss(tf), JG.gen_adv_loss(jf))
    close(TG.feature_matching_loss(tf, tr), JG.feature_matching_loss(jf, jr))


def test_gan_losses_accumulate_bf16_features_in_fp32():
    (_, tr), (_, tf) = _both(_features(6)), _both(_features(7))
    half = [[t.bfloat16() for t in sub] for sub in tf]
    assert TG.gen_adv_loss(half).dtype == torch.float32
    assert TG.feature_matching_loss(half, tr).dtype == torch.float32


def test_feature_matching_detaches_the_real_side():
    tr = [[t.requires_grad_(True) for t in sub] for sub in _both(_features(8))[1]]
    tf = [[t.requires_grad_(True) for t in sub] for sub in _both(_features(9))[1]]
    TG.feature_matching_loss(tf, tr).backward()
    assert all(t.grad is None for sub in tr for t in sub)
    assert all(t.grad is not None for sub in tf for t in sub[:-1])


@pytest.mark.parametrize("fft_sizes,hop_sizes,win_lengths",
                         [((128, 256, 512, 1024, 2048), (32, 64, 128, 256, 512),
                           (128, 256, 512, 1024, 2048)), ((256,), (50,), (200,))])
def test_stft_loss_matches_jax(fft_sizes, hop_sizes, win_lengths):
    x, y = wav(10, (2, 4000)), wav(11, (2, 4000))
    kw = dict(fft_sizes=fft_sizes, hop_sizes=hop_sizes, win_lengths=win_lengths)
    ref = jax.jit(lambda a, b: jax_stft_loss(a, b, **kw))(jnp.asarray(x), jnp.asarray(y))
    close(multi_resolution_stft_loss(torch.from_numpy(x), torch.from_numpy(y), **kw), ref)


def _port_disc(jcfg, disc_tree):
    disc = TD.Discriminator(PC.from_dict(dataclasses.asdict(jcfg)),
                            generator=torch.Generator().manual_seed(0))
    disc.load_state_dict(params_from_jax(disc_tree))
    return disc


def _hold_features(got, ref):
    assert len(got) == len(ref)
    for g_sub, r_sub in zip(got, ref):
        assert len(g_sub) == len(r_sub)
        for g, r in zip(g_sub, r_sub):
            assert tuple(g.shape) == r.shape
            close(g, r)


def _jax_disc_apply(jcfg, params, x):
    m = jcfg.model
    sp = m.mstft.stft_params

    def apply(params, x):
        return (JD.mpd_apply(params["mpd"], x, periods=tuple(m.mpd.periods))
                + JD.spec_discriminator_apply(
                    params["spec"], x, fft_sizes=tuple(sp.fft_sizes),
                    hop_sizes=tuple(sp.hop_sizes), win_lengths=tuple(sp.win_lengths),
                    downsample_scales=tuple(m.mstft.downsample_scales)))

    return jax.jit(apply)(params, x)


@pytest.mark.parametrize("T", [800, 1601])
def test_tiny_discriminators_match_jax(tiny_disc, T):
    """Every MPD and spectrogram feature map and the logits, tiny config; T = 1601
    needs the MPD's reflect pad for every period."""
    jcfg, params, tree = tiny_disc
    x = wav(12, (2, 1, T))
    ref = _jax_disc_apply(jcfg, params, jnp.asarray(x))
    got = TD.discriminator_apply(torch.from_numpy(x), _port_disc(jcfg, tree))
    _hold_features(got, ref)


def test_full_width_discriminators_match_jax():
    """Config()'s discriminators (periods 2-11, 16 -> 512 channels, five
    resolutions up to fft 2048) on one 0.125 s request."""
    jcfg = JaxConfig()
    params, tree = _jax_init_disc(jcfg, 3)
    x = wav(13, (1, 1, 2000))
    ref = _jax_disc_apply(jcfg, params, jnp.asarray(x))
    got = TD.discriminator_apply(torch.from_numpy(x), _port_disc(jcfg, tree))
    _hold_features(got, ref)


def test_discriminator_parameter_names_follow_the_jax_tree(tiny_disc):
    jcfg, _, tree = tiny_disc
    names = set(_port_disc(jcfg, tree).state_dict())
    assert names == set(params_from_jax(tree))
    assert {"mpd.discs.0.convs.0.v", "mpd.discs.1.out.g", "spec.discs.0.layers.4.b"} <= names
