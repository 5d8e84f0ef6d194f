"""The semantic branch's offline paths and CLIs on a small corpus (CPU),
with tests/test_torch_semantic.py's tiny ``concat_semantic`` codec and a
synthetic w2v-bert snapshot (HF ``save_pretrained`` of a random
1024-wide, 3-layer model, and its feature extractor's config):

- ``cli/precompute_semantic.py`` writes float16 (1024, Tf) targets within
  one float16 spacing (plus 1e-4 x the target's max, the fbank's own
  difference from HF's) of the JAX package's CLI on the same snapshot (HF
  transformers there);
- ``cli/extract_indices.py --semantic_dir`` at batch 2: int16 (T,) codes of
  ceil(len / hop) frames equal to each file's own ``tokenize`` with its
  target; without the targets it exits with JAX's message;
- ``train/loop.py::run_test`` with the teacher (``make_test_teacher``)
  against JAX's ``run_test`` with the same teacher's weights: SI-SNR,
  SI-SDR, the codebook's perplexity and use within 1e-4, STOI within 1e-3
  (tests/test_torch_loop.py's tolerances); without a teacher both return
  the skip marker;
- ``cli/train.py --w2v_bert_init random`` trains 2 steps (features from
  the loader, the teacher in the step) and logs ``semantic_recon_loss``;
  ``cli/inference_full.py --w2v_bert_init random`` evaluates whole files
  (the ragged codec with the teacher per file) and crops (the teacher on
  the loader's features).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from audiotokenization_tpu.cli import precompute_semantic as jax_precompute
from audiotokenization_tpu.data.dataset import AudioDataset as JDataset
from audiotokenization_tpu.data.dataset import DataLoader as JLoader
from audiotokenization_tpu.train import loop as jax_loop
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.cli import extract_indices, inference_full, precompute_semantic
from audiotokenization_tpu_torch.cli import train as train_cli
from audiotokenization_tpu_torch.data.audio_io import read_audio, write_wav
from audiotokenization_tpu_torch.data.dataset import AudioDataset, DataLoader
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.models.w2v_bert import load_w2v_bert_teacher
from audiotokenization_tpu_torch.train import loop

from test_torch_conformer_train import jax_tree
from test_torch_semantic import semantic_tiny, spread

HOP = 10
# (speaker, chapter, utterance, samples): none a whole number of hops
CORPUS = [(19, 198, 0, 7301), (19, 198, 1, 4003), (32, 21, 0, 9995), (32, 21, 1, 12347)]
EVAL_TOL, QUALITY_TOL = 1e-4, 1e-3  # tests/test_torch_loop.py


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The corpus and its filelist, the snapshot, and a port run dir of the
    tiny concat codec (its config's teacher is the snapshot's shape)."""
    from transformers import SeamlessM4TFeatureExtractor, Wav2Vec2BertConfig, Wav2Vec2BertModel

    tmp = tmp_path_factory.mktemp("semantic_cli")
    rng = np.random.RandomState(0)
    files = []
    for spk, chap, utt, n in CORPUS:
        path = tmp / "data" / "LibriSpeech" / "test-clean" / str(spk) / str(chap) / \
            f"{spk}-{chap}-{utt:04d}.wav"
        path.parent.mkdir(parents=True, exist_ok=True)
        t = np.arange(n) / 16000
        write_wav(path, (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t)
                         + 0.05 * rng.randn(n)).astype(np.float32), 16000)
        files.append(path)
    filelist = tmp / "files.txt"
    filelist.write_text("\n".join(str(f) for f in files))

    torch.manual_seed(0)
    hf = Wav2Vec2BertModel(Wav2Vec2BertConfig(
        hidden_size=1024, num_hidden_layers=3, num_attention_heads=4, intermediate_size=128,
        feature_projection_input_dim=160, layerdrop=0.0, hidden_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0, conformer_conv_dropout=0.0,
        position_embeddings_type="relative_key")).eval()
    snapshot = tmp / "w2v-bert"
    hf.save_pretrained(snapshot)
    SeamlessM4TFeatureExtractor().save_pretrained(snapshot)

    jcfg = semantic_tiny(True)
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    codec = spread(TC.init_codec(cfg, generator=torch.Generator().manual_seed(3), device="cpu"))
    run = tmp / "run"
    (run / "ckpt" / "0").mkdir(parents=True)
    PC.save_config(cfg, run / "config.json")
    torch.save({"step": 0, "gen": codec.state_dict()}, run / "ckpt" / "0" / "state.pt")
    return {"tmp": tmp, "files": files, "filelist": filelist, "snapshot": snapshot,
            "jcfg": jcfg, "cfg": cfg, "codec": codec, "run": run}


@pytest.fixture(scope="module")
def targets(world):
    """Both packages' precompute CLIs on the corpus: (port dir, JAX dir)."""
    out = {}
    for name, cli in (("port", precompute_semantic), ("jax", jax_precompute)):
        args = ["--filelist", str(world["filelist"]), "--out_dir", str(world["tmp"] / name),
                "--model_path", str(world["snapshot"]), "--layer", "2"]
        cli.main(args + (["--device", "cpu"] if name == "port" else []))
        out[name] = world["tmp"] / name
    return out


def test_precompute_matches_jax(world, targets):
    for f in world["files"]:
        got = np.load(targets["port"] / f"{f.stem}.npy")
        want = np.load(targets["jax"] / f"{f.stem}.npy")
        n = len(read_audio(f)[0][0])
        assert got.dtype == want.dtype == np.float16
        assert got.shape == want.shape == (1024, -(-(1 + (n + 320 - 400) // 160) // 2))
        g, w = got.astype(np.float32), want.astype(np.float32)
        tol = np.spacing(np.abs(want)).astype(np.float32) + 1e-4 * np.abs(w).max()
        assert (np.abs(g - w) <= tol).all(), f"{f.name}: max |d| {np.abs(g - w).max():.3g}"


def test_extract_with_semantic_dir(world, targets):
    run = world["run"]
    args = ["--dataset_root", str(world["tmp"] / "data"), "--save_path", str(run),
            "--dataset_path", "LibriSpeech", "--ext_audio", ".wav", "--subsets", "test-clean",
            "--batch_size", "2", "--device", "cpu"]
    with pytest.raises(SystemExit, match="pass --semantic_dir"):
        extract_indices.main(args)
    summary = extract_indices.main(args + ["--semantic_dir", str(targets["port"])])
    assert summary["saved"] == len(CORPUS) and summary["errors"] == 0
    _, codec = extract_indices.load_model(run, device="cpu")
    for f, (*_, n) in zip(world["files"], CORPUS):
        got = np.load(next((run / "extracted_indices").rglob(f"{f.stem}.npy")))
        frames = -(-n // HOP)
        assert got.dtype == np.int16 and got.shape == (frames,)
        wav = np.pad(read_audio(f)[0][0], (0, frames * HOP - n))
        sem = extract_indices.load_semantic_target(targets["port"], f.stem, frames)
        own = TC.tokenize(codec, torch.from_numpy(wav)[None],
                          semantic_target=torch.from_numpy(sem)[None])
        np.testing.assert_array_equal(got, own[0, 0].numpy().astype(np.int16), err_msg=f.name)


def test_run_test_with_the_teacher_matches_jax(world):
    cfg, jcfg, codec = world["cfg"], world["jcfg"], world["codec"]
    teacher = load_w2v_bert_teacher(world["snapshot"], device="cpu")
    split = dataclasses.replace(cfg.dataset.test, filelist=str(world["filelist"]),
                                batch_size=1, min_audio_length=-1)
    kw = dict(sample_rate=16000, pad_to_multiple_of=HOP)
    loader = DataLoader(AudioDataset(split, **kw), batch_size=1, shuffle=False,
                        drop_last=False)
    jloader = JLoader(JDataset(split, **kw), batch_size=1, shuffle=False, drop_last=False)
    got = loop.run_test(cfg, codec, loader, max_batches=2, teacher=teacher)
    want = jax_loop.run_test(jcfg, jax_tree(codec.state_dict()), jloader, max_batches=2,
                             teacher_params=jax_tree(teacher.state_dict()))
    for key in ("test_si_snr", "test_si_sdr", "test_codebook_perplexity",
                "test_codebook_utilization"):
        np.testing.assert_allclose(got[key], want[key], rtol=EVAL_TOL, atol=EVAL_TOL,
                                   err_msg=key)
    assert ("test_stoi" in got) == ("test_stoi" in want)
    if "test_stoi" in want:
        assert abs(got["test_stoi"] - want["test_stoi"]) <= QUALITY_TOL
    marker = {"test_skipped_concat_semantic": 1.0}
    assert loop.run_test(cfg, codec, loader) == marker
    assert jax_loop.run_test(jcfg, jax_tree(codec.state_dict()), jloader) == marker


def test_train_and_evaluate_with_a_random_teacher(world):
    cfg = PC.from_dict(dataclasses.asdict(world["jcfg"]))
    cfg.dataset.train.filelist = str(world["filelist"])
    cfg.dataset.train.batch_size, cfg.dataset.train.min_audio_length = 2, 1600
    cfg.train.log_every_n_steps = 1
    cfg_file = world["tmp"] / "semantic.json"
    PC.save_config(cfg, cfg_file)
    run = world["tmp"] / "train_run"
    state = train_cli.main(["--config", str(cfg_file), "--run_dir", str(run), "--device", "cpu",
                            "--no_wandb", "--skip_test", "--max_steps", "2",
                            "--w2v_bert_init", "random"])
    assert state.step == 2 and not any("w2v" in k for k in state.gen.state_dict())
    logs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    sem = [r["semantic_recon_loss"] for r in logs if "semantic_recon_loss" in r]
    assert len(sem) == 2 and all(np.isfinite(sem))
    common = ["--save_path", str(run), "--filelist", str(world["filelist"]), "--device", "cpu",
              "--num_examples", "0", "--w2v_bert_init", "random"]
    full = inference_full.main(common + ["--duration", "0", "--batch_size", "2",
                                         "--output_folder", "eval_full"])
    assert full["frames"] == sum(-(-n // HOP) for *_, n in CORPUS)
    crop = inference_full.main(common + ["--duration", "0.1", "--batch_size", "2",
                                         "--output_folder", "eval_crop"])
    assert crop["frames"] == len(CORPUS) * 1600 // HOP
    for summary in (full, crop):
        assert np.isfinite(summary["si_snr"]) and np.isfinite(summary["si_sdr"])
    with pytest.raises(SystemExit, match="needs teacher features"):
        inference_full.main(common[:-2] + ["--duration", "0", "--batch_size", "2"])
