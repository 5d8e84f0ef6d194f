"""The port's evaluation metrics against the JAX package's on the same
arrays: SI-SDR, SI-SNR, the masked (ragged) forms, codebook perplexity and
utilization within 1e-6; STOI (each package's resampler to 10 kHz) within
1e-5; PESQ (the P.862 pipeline; the port's own copy) within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.train import metrics as JM
from audiotokenization_tpu_torch.train import metrics as PM

TOL = 1e-6
STOI_TOL = 1e-5
PESQ_TOL = 1e-6


def _pair(seed, shape, noise=0.3):
    rng = np.random.RandomState(seed)
    t = (rng.randn(*shape) * 0.2).astype(np.float32)
    e = (t + noise * rng.randn(*shape) * 0.2 + 0.01).astype(np.float32)
    return e, t


@pytest.mark.parametrize("zero_mean", [False, True])
def test_si_sdr_and_si_snr_match_jax(zero_mean):
    e, t = _pair(0, (3, 1000))
    want = float(JM.si_sdr(jnp.asarray(e), jnp.asarray(t), zero_mean=zero_mean))
    got = float(PM.si_sdr(torch.from_numpy(e), torch.from_numpy(t), zero_mean=zero_mean))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if zero_mean:
        got = float(PM.si_snr(torch.from_numpy(e), torch.from_numpy(t)))
        np.testing.assert_allclose(got, float(JM.si_snr(jnp.asarray(e), jnp.asarray(t))),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("zero_mean", [False, True])
def test_masked_si_matches_jax_and_each_trimmed_row(zero_mean):
    e, t = _pair(1, (3, 900))
    lengths = np.asarray([900, 512, 37], np.int32)
    e[1, 512:] = 7.0  # garbage past a row's length must not count
    want = np.asarray(JM.masked_si(jnp.asarray(e), jnp.asarray(t), jnp.asarray(lengths),
                                   zero_mean=zero_mean))
    got = PM.masked_si(torch.from_numpy(e), torch.from_numpy(t), torch.from_numpy(lengths),
                       zero_mean=zero_mean)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    for i, n in enumerate(lengths):
        row = PM.si_sdr(torch.from_numpy(e[i, :n]), torch.from_numpy(t[i, :n]), zero_mean=zero_mean)
        np.testing.assert_allclose(got[i].item(), row.item(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hist", [[0, 3, 0, 1, 7, 0, 0, 2], [0] * 8, [5] + [0] * 7],
                         ids=["spread", "empty", "one-code"])
def test_codebook_statistics_match_jax(hist):
    h = np.asarray(hist, np.float32)
    for pf, jf in ((PM.perplexity_from_histogram, JM.perplexity_from_histogram),
                   (PM.utilization_from_histogram, JM.utilization_from_histogram)):
        np.testing.assert_allclose(float(pf(torch.from_numpy(h))), float(jf(jnp.asarray(h))),
                                   rtol=TOL, atol=TOL)
    codes = np.random.RandomState(2).randint(0, 64, (1, 3, 40))
    np.testing.assert_array_equal(PM.codebook_histogram(torch.from_numpy(codes), 64).numpy(),
                                  np.asarray(JM.codebook_histogram(jnp.asarray(codes), 64)))


def _speechlike(seed, n, sr=16000):
    """Noise under a syllable-rate envelope, with pauses (STOI drops silent
    frames), and a degraded copy."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / sr
    env = np.clip(np.sin(2 * np.pi * 3.0 * t), 0, None) ** 2
    clean = (env * (np.sin(2 * np.pi * 180 * t) + 0.5 * rng.randn(n)) * 0.3).astype(np.float32)
    noisy = (clean + 0.05 * rng.randn(n)).astype(np.float32)
    return clean, noisy


@pytest.mark.parametrize("fs", [16000, 10000])
def test_stoi_matches_jax(fs):
    clean, noisy = _speechlike(fs, 2 * fs, fs)
    want = JM.stoi(clean, noisy, fs)
    got = PM.stoi(clean, noisy, fs)
    assert np.isfinite(got) and 0 < got < 1
    np.testing.assert_allclose(got, want, rtol=0, atol=STOI_TOL)
    assert np.isnan(PM.stoi(clean[:300], noisy[:300], fs)) and np.isnan(JM.stoi(clean[:300], noisy[:300], fs))


def test_pesq_matches_jax():
    clean, noisy = _speechlike(4, 32000)
    assert PM.pesq_impl() == JM.pesq_impl()
    want = JM.pesq_metric(clean, noisy, 16000)
    got = PM.pesq_metric(clean, noisy, 16000)
    assert want is not None and got is not None
    np.testing.assert_allclose(got, want, rtol=0, atol=PESQ_TOL)
