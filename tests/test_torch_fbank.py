"""The port's w2v-bert input features (``ops/fbank.py``) against the JAX
package's copy:

- the numpy pipeline (``kaldi_mel_filters``, ``povey_window``, ``fbank``,
  ``w2v_bert_features``, ``w2v_bert_features_from_clip``) equal bit for
  bit, on lengths with an even and an odd frame count and on one shorter
  than a frame;
- ``w2v_bert_features_torch`` against ``w2v_bert_features_jax`` on the
  same batch, and against the numpy extractor, within tests/test_fbank.py's
  bound for the JAX one (rtol 3e-3 / atol 3e-3: fp32 FFT against float64);
- ``feature_frames`` counts what the extractor returns.
"""
import numpy as np
import pytest
import torch

from audiotokenization_tpu.ops import fbank as JF
from audiotokenization_tpu_torch.ops import fbank as TF

BATCH_RTOL = BATCH_ATOL = 3e-3  # tests/test_fbank.py::test_jax_variant_matches_numpy


def test_tables_equal_jax():
    np.testing.assert_array_equal(TF.kaldi_mel_filters(), JF.kaldi_mel_filters())
    np.testing.assert_array_equal(TF.povey_window(), JF.povey_window())


@pytest.mark.parametrize("n", [16320, 16000, 12345, 720, 399])
def test_numpy_features_equal_jax(n):
    wav = (np.random.RandomState(n).randn(n) * 0.1).astype(np.float32)
    for name in ("fbank", "w2v_bert_features", "w2v_bert_features_from_clip"):
        got, want = getattr(TF, name)(wav), getattr(JF, name)(wav)
        assert got.dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert TF.feature_frames(n) == len(TF.w2v_bert_features_from_clip(wav))


@pytest.mark.parametrize("n", [16000, 12345])
def test_torch_batch_matches_jax_and_numpy(n):
    wav = (np.random.RandomState(3).randn(4, n) * 0.1).astype(np.float32)
    got = TF.w2v_bert_features_torch(torch.from_numpy(wav))
    assert got.dtype == torch.float32
    want = np.asarray(JF.w2v_bert_features_jax(wav))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=BATCH_RTOL, atol=BATCH_ATOL)
    numpy = np.stack([TF.w2v_bert_features_from_clip(w) for w in wav])
    np.testing.assert_allclose(got.numpy(), numpy, rtol=BATCH_RTOL, atol=BATCH_ATOL)
    unpadded = TF.w2v_bert_features_torch(torch.from_numpy(wav), pad_clip=False)
    np.testing.assert_allclose(unpadded.numpy(),
                               np.asarray(JF.w2v_bert_features_jax(wav, pad_clip=False)),
                               rtol=BATCH_RTOL, atol=BATCH_ATOL)
