"""The port's offline paths on a trained codec against the JAX package's,
on the tiny config (CPU):

- ``make_ragged_tokenizer``: token for token equal to JAX's ragged
  tokenizer and to the port's per-file ``tokenize``, on float32 and int16
  batches with a zero-length row;
- ``cli/extract_indices.py``: the same ``.npy`` tree (files, int16, values)
  as JAX's CLI on the same weights, read from a port run dir, from a JAX
  (Orbax) run dir converted by ``scripts/jax_run_to_torch.py`` and from a
  synthetic reference run dir (``hydra/config.yaml`` + ``pl_log/last.ckpt``),
  at ``--batch_size`` 1 and 3 and with ``--exact``, on a corpus with a
  24 kHz file;
- ``cli/inference_full.py``: the summary against JAX's CLI, whole files
  (``--duration 0 --batch_size 4``) and crops (``--duration 0.1
  --batch_size 2``): SI-SNR / SI-SDR within rtol 1e-4, STOI within 1e-3,
  codes used, frames and utilization equal, perplexities within rtol 1e-5;
  PESQ as tests/test_torch_loop.py holds it (the port's ``pesq_metric`` on
  the port's example wavs against JAX's on the same wavs, 1e-6);
- ``cli/synthesize.py``: the waveform of its tokens against JAX's
  ``decode`` within rtol 1e-3 / atol 2e-5, the repo's waveform tolerance;
- ``ops/stft.py::mel_spectrogram`` against JAX's within 1e-5;
- the parallel flags on one listed device (tests/test_torch_parallel_cli.py
  runs them over several), and the validation spectrogram PNG.
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.cli import extract_indices as jax_extract
from audiotokenization_tpu.cli import inference_full as jax_eval
from audiotokenization_tpu.data.audio_io import write_wav
from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu.ops import stft as JS
from audiotokenization_tpu.ops.conv import fold_weight_norm as jax_fold
from audiotokenization_tpu.train.metrics import pesq_metric as jax_pesq_metric
from audiotokenization_tpu.utils.ragged import make_ragged_tokenizer as jax_ragged_tokenizer
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.cli import extract_indices, inference_full, synthesize
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.data.audio_io import read_wav
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.ops import stft as TS
from audiotokenization_tpu_torch.train import loop
from audiotokenization_tpu_torch.train.checkpoint import CheckpointManager
from audiotokenization_tpu_torch.train.metrics import pesq_metric
from audiotokenization_tpu_torch.train.state import init_train_state
from audiotokenization_tpu_torch.utils.ragged import make_ragged_tokenizer

from test_torch_convert import tiny, write_jax_run, write_reference_run

import jax_run_to_torch  # scripts/, on the path through test_torch_convert

SI_RTOL = 1e-4
STOI_TOL = 1e-3
PPL_RTOL = 1e-5
PESQ_TOL = 1e-6
WAV_RTOL, WAV_ATOL = 1e-3, 2e-5
MEL_TOL = 1e-5
HOP = 10  # the tiny config's
# (speaker, chapter, utterance, samples, rate): lengths off the hop, two
# 1 s buckets, one file at 24 kHz (resampled to 14000 samples)
CORPUS = [(19, 198, 0, 9731, 16000), (19, 198, 1, 12000, 16000), (19, 198, 2, 17003, 16000),
          (26, 495, 0, 15555, 16000), (26, 495, 1, 21000, 24000)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small CPU ops: one intra-op thread, as in test_torch_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spread_codes(tree):
    """The tree with the encoder's LSTM and output biases and the VQ's input
    projection bias zeroed. At init those biases dominate the latents, and
    every frame takes the same code; without them the corpus below uses
    most of the 64 codes, so that the perplexities compare something."""
    enc, layer = tree["encoder"], tree["quantizer"]["layers"][0]
    for p in [*enc["lstm"], enc["conv_out"], layer["in_proj"]]:
        for k in ("b", "b_ih", "b_hh"):
            if k in p:
                p[k] = np.zeros_like(p[k])
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One set of tiny weights as a JAX run dir, a port run dir, a converted
    JAX run dir and a reference run dir, and a LibriSpeech-layout corpus
    with its filelist."""
    tmp = tmp_path_factory.mktemp("extract")
    jcfg = tiny()
    tree = spread_codes(jax.tree.map(np.asarray, JC.init_codec(jax.random.key(7), jcfg)))
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    jax_run = write_jax_run(tmp / "jax_run", tree, jcfg)
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    state.gen.load_state_dict(params_from_jax(tree))
    mngr = CheckpointManager(tmp / "port_run", cfg)
    mngr.save(state)
    mngr.wait()
    jax_run_to_torch.convert_run(jax_run, tmp / "converted_run")
    write_reference_run(tmp / "reference_run", tree, jcfg)

    rng = np.random.RandomState(0)
    root = tmp / "datasets" / "LibriSpeech" / "test-clean"
    files = []
    for spk, chap, utt, n, sr in CORPUS:
        d = root / str(spk) / str(chap)
        d.mkdir(parents=True, exist_ok=True)
        t = np.arange(n) / sr
        w = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) * np.abs(np.sin(3 * t))
             + 0.05 * rng.randn(n)).astype(np.float32)
        path = d / f"{spk}-{chap}-{utt:04d}.wav"
        write_wav(path, w, sr)
        files.append(str(path))
    filelist = tmp / "test.txt"
    filelist.write_text("\n".join(files))
    return {"tmp": tmp, "jcfg": jcfg, "tree": tree, "cfg": cfg, "jax": jax_run,
            "port": tmp / "port_run", "converted": tmp / "converted_run",
            "reference": tmp / "reference_run", "datasets": tmp / "datasets",
            "filelist": filelist}


# -- the ragged tokenizer ---------------------------------------------------

@pytest.mark.parametrize("pcm16", [False, True], ids=["float32", "int16"])
def test_ragged_tokenizer_matches_jax_and_per_file(runs, pcm16):
    lengths = [730, 0, 1000, 400]
    rng = np.random.RandomState(3)
    ints = np.zeros((len(lengths), 1000), np.int16)
    for i, n in enumerate(lengths):
        ints[i, :n] = (rng.randn(n) * 3000).astype(np.int16)
    wavs = ints if pcm16 else (rng.randn(len(lengths), 1000) * 0.1).astype(np.float32)
    if not pcm16:
        for i, n in enumerate(lengths):
            wavs[i, n:] = 0
    lens = np.asarray(lengths, np.int32)
    want = np.asarray(jax_ragged_tokenizer(runs["jcfg"])(
        jax.tree.map(jnp.asarray, runs["tree"]), jnp.asarray(wavs), jnp.asarray(lens)))
    codec = TC.init_codec(runs["cfg"], generator=torch.Generator().manual_seed(0), device="cpu")
    codec.load_state_dict(params_from_jax(runs["tree"]))
    got = make_ragged_tokenizer(runs["cfg"], device="cpu")(
        codec, torch.from_numpy(wavs), torch.from_numpy(lens)).numpy()
    assert got.shape == want.shape == (1, len(lengths), 100)
    floats = ints.astype(np.float32) / 32768.0 if pcm16 else wavs
    for i, n in enumerate(lengths):
        np.testing.assert_array_equal(got[:, i, :n // HOP], want[:, i, :n // HOP])
        if n:
            own = TC.tokenize(codec, torch.from_numpy(floats[i:i + 1, :n])).numpy()[:, 0]
            np.testing.assert_array_equal(got[:, i, :n // HOP], own)


def test_ragged_tokenizer_refuses_unported_modes(runs):
    """Every tokenize mode is ported now (tests/test_torch_modes.py); only
    an unknown one raises."""
    for mode in ("conformant", "high", "balanced", "fast"):
        assert callable(make_ragged_tokenizer(runs["cfg"], mode=mode, device="cpu"))
    with pytest.raises(ValueError):
        make_ragged_tokenizer(runs["cfg"], mode="bogus", device="cpu")


def test_mel_spectrogram_matches_jax():
    x = (np.random.RandomState(1).randn(2, 5000) * 0.2).astype(np.float32)
    want = np.asarray(JS.mel_spectrogram(jnp.asarray(x), sample_rate=16000, n_fft=1024,
                                         hop_length=256, n_mels=128))
    got = TS.mel_spectrogram(torch.from_numpy(x), sample_rate=16000, n_fft=1024,
                             hop_length=256, n_mels=128).numpy()
    assert got.shape == want.shape == (2, 128, 5000 // 256 + 1)
    np.testing.assert_allclose(got, want, rtol=MEL_TOL, atol=MEL_TOL)


# -- extraction ---------------------------------------------------------------

EXTRACT_MODES = {"batch1": ["--batch_size", "1"], "batch3": ["--batch_size", "3"],
                 "exact": ["--exact"]}


def _extract_args(runs, save_path, folder, mode):
    return ["--dataset_root", str(runs["datasets"]), "--save_path", str(save_path),
            "--output_folder", folder, "--dataset_path", "LibriSpeech", "--ext_audio", ".wav",
            "--subsets", "test-clean", *EXTRACT_MODES[mode]]


def _npy_tree(root):
    return {str(p.relative_to(root)): np.load(p) for p in sorted(root.rglob("*.npy"))}


@pytest.fixture(scope="module")
def jax_extracted(runs):
    """JAX's CLI on the JAX run dir, once per mode."""
    out = {}
    for mode in EXTRACT_MODES:
        jax_extract.main(_extract_args(runs, runs["jax"], f"jax_{mode}", mode))
        out[mode] = _npy_tree(runs["jax"] / f"jax_{mode}")
    return out


@pytest.mark.parametrize("mode", list(EXTRACT_MODES))
@pytest.mark.parametrize("layout", ["port", "converted", "reference"])
def test_extract_cli_matches_jax(runs, jax_extracted, layout, mode, capsys):
    summary = extract_indices.main(_extract_args(runs, runs[layout], f"port_{mode}", mode)
                                   + ["--device", "cpu"])
    got, want = _npy_tree(runs[layout] / f"port_{mode}"), jax_extracted[mode]
    assert len(want) == len(CORPUS) and got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype == np.int16, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert summary["saved"] == len(CORPUS) and summary["errors"] == 0
    # 5 files at batch 1; at batch 3 the 1 s bucket's 3 int16 files, the 2 s
    # bucket's int16 file and the resampled (float32) file; one call a file exact
    assert summary["device_batches"] == {"batch1": 5, "batch3": 3, "exact": 5}[mode]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"saved", "errors", "audio_seconds", "wall_seconds", "audio_s_per_s"} <= line.keys()


def test_extract_cli_refuses_what_is_not_ported(runs):
    """Sequence and tensor parallelism are ported (tests/test_torch_parallel_cli.py):
    ``--sequence_parallel`` on the one listed CPU writes the plain tokens,
    ``--tensor_parallel 2`` exits as JAX's CLI does when the degree exceeds
    the devices; ``--semantic_dir`` is ported: a checkpoint without
    ``concat_semantic`` reads no target and writes the same tokens
    (tests/test_torch_semantic_cli.py runs a concat one)."""
    base = _extract_args(runs, runs["port"], "never", "batch1") + ["--device", "cpu"]
    with pytest.raises(SystemExit, match="--tensor_parallel 2 exceeds the 1 attached devices"):
        extract_indices.main(base + ["--tensor_parallel", "2"])
    extract_indices.main(_extract_args(runs, runs["port"], "sem_plain", "batch1")
                         + ["--device", "cpu"])
    extract_indices.main(_extract_args(runs, runs["port"], "sem_dir", "batch1")
                         + ["--device", "cpu", "--semantic_dir", str(runs["tmp"] / "absent")])
    extract_indices.main(_extract_args(runs, runs["port"], "sp_one", "batch1")
                         + ["--device", "cpu", "--sequence_parallel"])
    want = _npy_tree(runs["port"] / "sem_plain")
    assert len(want) == len(CORPUS)
    for folder in ("sem_dir", "sp_one"):
        got = _npy_tree(runs["port"] / folder)
        assert got.keys() == want.keys(), folder
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{folder} {name}")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            extract_indices.main(base[:-2])  # the default device is the card


# -- evaluation ---------------------------------------------------------------

EVAL_CASES = {"full": ["--duration", "0", "--batch_size", "4"],
              "crop": ["--duration", "0.1", "--batch_size", "2"]}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_inference_full_matches_jax(runs, case):
    common = ["--filelist", str(runs["filelist"]), "--num_examples", "2", *EVAL_CASES[case]]
    stdout = sys.stdout
    try:  # JAX's CLI leaves its log tee on stdout
        jax_eval.main(["--save_path", str(runs["jax"]), "--output_folder", f"eval_{case}"]
                      + common)
    finally:
        sys.stdout = stdout
    want = json.loads((runs["jax"] / f"eval_{case}" / "summary.json").read_text())
    out_dir = runs["port"] / f"eval_{case}"
    got = inference_full.main(["--save_path", str(runs["port"]), "--output_folder",
                               f"eval_{case}", "--device", "cpu"] + common)
    assert sys.stdout is stdout
    assert got == json.loads((out_dir / "summary.json").read_text())
    for key in ("si_snr", "si_sdr"):
        np.testing.assert_allclose(got[key], want[key], rtol=SI_RTOL, err_msg=key)
    if want["stoi"] is None:
        assert got["stoi"] is None
    else:
        assert abs(got["stoi"] - want["stoi"]) <= STOI_TOL
    for key in ("codebook_used", "codebook_size", "frames", "utilization"):
        assert got[key] == want[key], key
    for key in ("perplexity_raw", "perplexity_normalized"):
        np.testing.assert_allclose(got[key], want[key], rtol=PPL_RTOL, err_msg=key)
    assert got["frames"] == (sum(-(-n * 16000 // sr // HOP) for *_, n, sr in CORPUS)
                             if case == "full" else len(CORPUS) * 1600 // HOP)
    assert got["codebook_used"] > 16
    pesq_pairs = 0
    for i in range(2):
        gt, _ = read_wav(out_dir / f"example_{i}_gt.wav")
        est, _ = read_wav(out_dir / f"example_{i}_recon.wav")
        p, q = pesq_metric(gt[0], est[0], 16000), jax_pesq_metric(gt[0], est[0], 16000)
        assert (p is None) == (q is None)
        if p is not None:
            pesq_pairs += 1
            assert abs(p - q) <= PESQ_TOL
        assert (out_dir / f"example_{i}_spec.png").exists()
    assert pesq_pairs == (2 if case == "full" else 0)
    assert (out_dir / "codebook_usage.png").exists()
    assert "si_snr" in (out_dir / "log.txt").read_text()


def test_inference_full_refuses_semantic(runs):
    """The teacher flags are ported: a checkpoint without the semantic branch
    needs no teacher, so ``--w2v_bert_path`` is not read and the summary is
    the one without it (tests/test_torch_semantic_cli.py evaluates a
    semantic run)."""
    common = ["--save_path", str(runs["port"]), "--filelist", str(runs["filelist"]),
              "--num_examples", "0", "--device", "cpu", *EVAL_CASES["crop"]]
    plain = inference_full.main(common + ["--output_folder", "eval_no_teacher"])
    flagged = inference_full.main(common + ["--output_folder", "eval_teacher_flag",
                                            "--w2v_bert_path", str(runs["tmp"] / "absent")])
    for key in ("si_snr", "si_sdr", "stoi", "codebook_used", "frames", "perplexity_raw"):
        assert flagged[key] == plain[key], key


# -- synthesis ----------------------------------------------------------------

def test_synthesize_matches_jax_decode(runs):
    out = runs["tmp"] / "synth"
    wav = synthesize.main(["--codec_ckpt", str(runs["converted"]), "--random", "--seconds",
                           "0.05", "--num_samples", "3", "--seed", "4", "--out_dir", str(out),
                           "--device", "cpu"])
    tokens = np.load(out / "tokens.npy")
    assert tokens.dtype == np.int16 and tokens.shape == (3, 80)
    assert len({tuple(r) for r in tokens}) == 3 and tokens.max() < 64
    params = jax_fold(jax.tree.map(jnp.asarray, runs["tree"]))
    emb = JC.apply_fc_post_a(params, runs["jcfg"], JC.codes_to_emb(
        params, runs["jcfg"], jnp.asarray(tokens, jnp.int32)[..., None]))
    want = np.asarray(JC.decode(params, runs["jcfg"], emb))[:, 0]
    assert wav.shape == want.shape == (3, 800)
    np.testing.assert_allclose(wav, want, rtol=WAV_RTOL, atol=WAV_ATOL)
    for i in range(3):
        assert (out / f"sample_{i}.wav").exists()


def test_synthesize_refuses_what_is_not_ported(runs, monkeypatch):
    """--lm_ckpt (tests/test_torch_token_lm_cli.py) and the parallel modes
    (tests/test_torch_parallel_cli.py) are ported: --sequence_parallel on
    the one listed CPU decodes the plain waveform; --pipeline_parallel
    refuses a BigCodec decoder with JAX's message (two CPUs listed, so that
    the stages fit), and --lm_ckpt with --sequence_parallel reads the LM
    first."""
    base = ["--codec_ckpt", str(runs["port"]), "--random", "--device", "cpu", "--seconds",
            "0.05", "--num_samples", "2"]
    tmp = runs["tmp"]
    plain = synthesize.main(base + ["--out_dir", str(tmp / "synth_plain")])
    got = synthesize.main(base + ["--out_dir", str(tmp / "synth_sp"), "--sequence_parallel"])
    np.testing.assert_allclose(got, plain, rtol=WAV_RTOL, atol=WAV_ATOL)
    from audiotokenization_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "visible_devices", lambda device="cuda": [torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="pipeline parallelism targets the conformer family"):
        synthesize.main(base + ["--pipeline_parallel", "2"])
    with pytest.raises(FileNotFoundError):
        synthesize.main(base[:2] + ["--lm_ckpt", str(tmp / "absent_lm"), "--device", "cpu",
                                    "--sequence_parallel"])
    # --streaming is ported (tests/test_torch_streaming.py); it excludes the others
    with pytest.raises(SystemExit, match="pick one"):
        synthesize.main(base + ["--streaming", "4", "--sequence_parallel"])


def test_validation_artifacts_include_the_spectrogram(tmp_path):
    x = (np.random.RandomState(2).randn(2, 4000) * 0.1).astype(np.float32)
    loop._dump_val_artifacts(tmp_path, 3, 8, x[0], x[1], 16000)
    names = {p.name for p in (tmp_path / "val_batch_3").iterdir()}
    assert names == {"step8_original.wav", "step8_reconstructed.wav", "step8_spec.png"}
