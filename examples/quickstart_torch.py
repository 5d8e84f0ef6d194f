"""End-to-end quickstart of the PyTorch/CUDA port on synthetic audio (no
dataset needed): the counterpart of ``examples/quickstart.py``.

Builds a tiny corpus, trains a small codec for a few steps, extracts token
indices and runs the reconstruction eval: the reference workflow
(preprocess -> train -> extract_indices -> inference_full) in miniature,
through the port's CLIs (``audiotokenization_tpu_torch.cli``), with the
JAX quickstart's tiny config.

Run from the repo root:

    python examples/quickstart_torch.py [workdir]               # on the card
    python examples/quickstart_torch.py [workdir] --device cpu  # plain PyTorch

On the card the first call builds the CUDA kernels (``csrc/``) into the
port's kernel cache (``utils/compile_cache.py``). An installed port runs the
same steps as its ``audiotok-torch-*`` scripts (``steps``).
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

SR = 16000
SPEAKERS = [(19, 198, 3), (26, 495, 2)]  # (speaker, chapter, utterances)


def write_corpus(work: Path):
    """A LibriSpeech-layout test-clean corpus of 0.2 s tones in noise."""
    from audiotokenization_tpu_torch.data.audio_io import write_wav

    rng = np.random.RandomState(0)
    for spk, chap, n in SPEAKERS:
        d = work / "data/LibriSpeech/test-clean" / str(spk) / str(chap)
        d.mkdir(parents=True, exist_ok=True)
        for u in range(n):
            t = np.arange(3200) / SR
            wav = (0.3 * np.sin(2 * np.pi * (180 + 60 * u) * t)
                   + 0.05 * rng.randn(len(t))).astype(np.float32)
            write_wav(d / f"{spk}-{chap}-{u:04d}.wav", wav, SR)


def tiny_config(work: Path) -> dict:
    """The JAX quickstart's tiny config, as a config overlay."""
    return {
        "name": "quickstart",
        "train": {"precision": "fp32", "max_steps": 5, "log_every_n_steps": 1,
                  "checkpoint_every_n_steps": 5, "val_every_n_steps": 1000},
        "model": {
            "codec_encoder": {"ngf": 4, "out_channels": 32, "up_ratios": [2, 5],
                              "rnn_num_layers": 1},
            "codec_decoder": {"in_channels": 32, "upsample_initial_channel": 16,
                              "up_ratios": [5, 2], "rnn_num_layers": 1, "codebook_size": 64,
                              "codebook_dim": 8},
            "mpd": {"periods": [2, 3], "channels": 4, "max_downsample_channels": 16},
            "mstft": {"stft_params": {"fft_sizes": [128, 256], "hop_sizes": [32, 64],
                                      "win_lengths": [128, 256]},
                      "channels": 4, "max_downsample_channels": 16},
        },
        "dataset": {"train": {"filelist": str(work / "filelists/librispeech_test_clean.txt"),
                              "batch_size": 2, "min_audio_length": 800},
                    "pad_to_multiple_of": 10},
    }


def steps(work: Path, device: str) -> list:
    """(CLI module, argv) of each step after the corpus: preprocess, train,
    extract_indices, inference_full. The installed script of module
    ``<m>`` is ``audiotok-torch-<m>`` (``extract`` for ``extract_indices``)."""
    run = str(work / "run")
    return [
        ("preprocess", ["--root", str(work / "data/LibriSpeech"),
                        "--out_dir", str(work / "filelists"), "--ext_audio", ".wav",
                        "--groups", "test_clean"]),
        ("train", ["--config", str(work / "tiny.json"), "--run_dir", run, "--no_wandb",
                   "--device", device]),
        ("extract_indices", ["--dataset_root", str(work / "data"), "--save_path", run,
                             "--dataset_path", "LibriSpeech", "--ext_audio", ".wav",
                             "--subsets", "test-clean", "--device", device]),
        ("inference_full", ["--save_path", run, "--batch_size", "2", "--duration", "0.05",
                            "--num_examples", "2", "--device", device]),
    ]


def prepare(work: Path):
    """The corpus and the config file."""
    work.mkdir(parents=True, exist_ok=True)
    write_corpus(work)
    (work / "tiny.json").write_text(json.dumps(tiny_config(work), indent=2))


def main(argv=None):
    import importlib

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("workdir", nargs="?", default="quickstart_out")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    work = Path(args.workdir)
    prepare(work)
    for module, cli_args in steps(work, args.device):
        importlib.import_module(f"audiotokenization_tpu_torch.cli.{module}").main(cli_args)

    print("\nquickstart artifacts under:", work)
    print("  tokens:", *(work / "run/extracted_indices").rglob("*.npy"))
    print("  eval:  ", work / "run/inference_full/summary.json")


if __name__ == "__main__":
    main()
