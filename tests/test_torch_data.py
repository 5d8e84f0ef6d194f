"""The port's data pipeline against the JAX package's: WAV and FLAC reading
(the repo's native FLAC decoder through the port's own ctypes binding),
the resampler, and the loader's batches over two epochs from the same
filelist and seed.

Tolerances: 16 kHz files byte for byte (the same int16 scaling, the same
crops from the same per-item seeds); a 24 kHz file goes through each
package's resampler, within 1e-6; ``resample`` within 1e-6 of JAX's.
"""
import numpy as np
import pytest
import torch

from flac_encoder import encode_flac

from audiotokenization_tpu.config import DatasetSplit as JSplit
from audiotokenization_tpu.data import audio_io as JIO
from audiotokenization_tpu.data.dataset import AudioDataset as JDataset
from audiotokenization_tpu.data.dataset import DataLoader as JLoader
from audiotokenization_tpu.data.flac import decode_flac_file as jax_decode_flac_file
from audiotokenization_tpu.ops.resample import resample as jax_resample
from audiotokenization_tpu_torch.config import DatasetSplit as PSplit
from audiotokenization_tpu_torch.data import audio_io as PIO
from audiotokenization_tpu_torch.data import flac as PF
from audiotokenization_tpu_torch.data.dataset import AudioDataset, DataLoader
from audiotokenization_tpu_torch.ops.resample import resample

RESAMPLE_TOL = 1e-6


def _write(path, x, sr, kind):
    """x float32 in [-1, 1]; kind 'wav' (PCM16) or 'flac' (16-bit)."""
    if kind == "flac":
        pcm = np.clip(np.round(x * 32767), -32768, 32767).astype(np.int64)[None]
        path.write_bytes(encode_flac(pcm, sr, mode="fixed2"))
    else:
        JIO.write_wav(path, x, sr)


def _corpus(tmp_path, kind):
    """Seven clips of 600-1400 samples, some shorter than the crop; 'wav24k'
    puts one 24 kHz file among 16 kHz ones."""
    rng = np.random.RandomState(3)
    files = []
    for i, n in enumerate((600, 1400, 900, 1100, 700, 1300, 1000)):
        sr = 24000 if (kind == "wav24k" and i == 2) else 16000
        ext = "flac" if kind == "flac" else "wav"
        p = tmp_path / f"clip{i}.{ext}"
        _write(p, (rng.randn(n * sr // 16000) * 0.1).astype(np.float32), sr, ext)
        files.append(p.name)
    fl = tmp_path / "list.txt"
    fl.write_text("\n".join(f"{f}\tspeaker{i}" for i, f in enumerate(files)))
    return fl


@pytest.mark.parametrize("kind", ["wav", "flac", "wav24k"])
@pytest.mark.parametrize("train", [True, False], ids=["train-crop", "eval-full"])
def test_loader_batches_equal_jax_for_two_epochs(tmp_path, kind, train):
    fl = _corpus(tmp_path, kind)
    split = dict(filelist=str(fl), batch_size=2, shuffle=train,
                 min_audio_length=800 if train else -1)
    ds_kw = dict(sample_rate=16000, pad_to_multiple_of=10 if train else 320,
                 root=str(tmp_path), train=train)
    ld_kw = dict(batch_size=2, shuffle=train, seed=5, num_workers=3, drop_last=train)
    jl = JLoader(JDataset(JSplit(**split), **ds_kw), **ld_kw)
    pl = DataLoader(AudioDataset(PSplit(**split), **ds_kw), **ld_kw)
    assert len(pl) == len(jl)
    for epoch in range(2):
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) == len(jl)
        for a, b in zip(jb, pb):
            assert isinstance(b["wav"], torch.Tensor) and b["wav"].dtype == torch.float32
            np.testing.assert_array_equal(b["lengths"].numpy(), a["lengths"])
            if kind == "wav24k":
                np.testing.assert_allclose(b["wav"].numpy(), a["wav"], rtol=0, atol=RESAMPLE_TOL)
            else:
                np.testing.assert_array_equal(b["wav"].numpy(), a["wav"])
    assert pl.epoch == jl.epoch == 2


@pytest.mark.parametrize("orig,new", [(24000, 16000), (22050, 16000), (8000, 16000)])
def test_resample_matches_jax(orig, new):
    x = (np.random.RandomState(orig).randn(2, 3001) * 0.3).astype(np.float32)
    want = np.asarray(jax_resample(x, orig, new))
    got = resample(torch.from_numpy(x), orig, new)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESAMPLE_TOL)
    assert resample(x, new, new) is x


@pytest.mark.parametrize("mode,channels,sr", [("verbatim", 2, 24000), ("constant", 1, 16000),
                                              ("fixed2", 1, 16000)])
def test_flac_decode_equals_jax(tmp_path, mode, channels, sr):
    rng = np.random.RandomState(channels)
    if mode == "constant":
        x = np.full((channels, 700), -1234, np.int64)
    elif mode == "fixed2":
        x = (6000 * np.sin(2 * np.pi * 220 * np.arange(2048) / sr)).astype(np.int64)[None]
    else:
        x = (rng.randn(channels, 777) * 8000).astype(np.int64).clip(-32768, 32767)
    path = tmp_path / "a.flac"
    path.write_bytes(encode_flac(x, sr, mode=mode))
    got, got_sr = PF.decode_flac_file(path)
    want, want_sr = jax_decode_flac_file(path)
    assert got_sr == want_sr == sr and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert PF.library_path().parent.parts[-2:] == ("build", "native")


def test_flac_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises; no other decoder steps in."""
    bad = tmp_path / "flacdec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(PF, "_SRC", bad)
    monkeypatch.setenv("ATT_TORCH_CACHE", str(tmp_path / "build"))
    monkeypatch.setattr(PF, "_LIB", None)
    with pytest.raises(RuntimeError, match="building the FLAC decoder failed"):
        PF.decode_flac_bytes(b"fLaC")
    assert not list((tmp_path / "build").rglob("*.so"))


def test_wav_io_matches_jax(tmp_path):
    """write_wav gives the same bytes; read_wav and read_audio the same arrays
    (PCM16, and a 24-bit and a float file written by hand)."""
    x = (np.random.RandomState(9).randn(2, 500) * 0.4).astype(np.float32)
    PIO.write_wav(tmp_path / "p.wav", x, 22050)
    JIO.write_wav(tmp_path / "j.wav", x, 22050)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    for fmt, bits, data in [(1, 24, np.random.RandomState(1).randint(0, 256, 900).astype(np.uint8)),
                            (3, 32, x[0])]:
        raw = data.tobytes()
        hdr = (b"RIFF" + (36 + len(raw)).to_bytes(4, "little") + b"WAVEfmt "
               + (16).to_bytes(4, "little") + fmt.to_bytes(2, "little") + (1).to_bytes(2, "little")
               + (16000).to_bytes(4, "little") + (0).to_bytes(4, "little")
               + (0).to_bytes(2, "little") + bits.to_bytes(2, "little")
               + b"data" + len(raw).to_bytes(4, "little"))
        (tmp_path / f"f{bits}.wav").write_bytes(hdr + raw)
    for name in ("p.wav", "f24.wav", "f32.wav"):
        got, got_sr = PIO.read_audio(tmp_path / name)
        want, want_sr = JIO.read_audio(tmp_path / name)
        assert got_sr == want_sr
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unsupported audio format"):
        PIO.read_audio(tmp_path / "a.mp3")


def test_semantic_items_are_not_ported(tmp_path):
    """The semantic branch's items are ported: with ``semantic_dir`` (float16
    (1024, Tf) targets, crops at multiples of the hop) and ``compute_feats``
    the training loader's batches equal the JAX loader's, key for key."""
    fl = _corpus(tmp_path, "wav")
    hop = 10
    rng = np.random.RandomState(9)
    for line in fl.read_text().splitlines():
        name = line.split("\t")[0]
        n = len(PIO.read_audio(tmp_path / name)[0][0])
        np.save(tmp_path / (name.rsplit(".", 1)[0] + ".npy"),
                rng.randn(1024, n // hop).astype(np.float16))
    split = dict(filelist=str(fl), batch_size=2, shuffle=True, min_audio_length=800)
    ds_kw = dict(sample_rate=16000, pad_to_multiple_of=hop, root=str(tmp_path), train=True,
                 semantic_dir=str(tmp_path), compute_feats=True, hop_length=hop)
    ld_kw = dict(batch_size=2, shuffle=True, seed=5, num_workers=2, drop_last=True)
    want = list(JLoader(JDataset(JSplit(**split), **ds_kw), **ld_kw))
    got = list(DataLoader(AudioDataset(PSplit(**split), **ds_kw), **ld_kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"wav", "lengths", "feats", "semantic_target"}
        assert tuple(g["semantic_target"].shape) == (2, 1024, 800 // hop)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)
