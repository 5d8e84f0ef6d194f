"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from the
root of the checkout. Tests marked ``chip`` need a CUDA device and skip
without one (decided inside the test); run them on the card with
``python -m pytest portbench/tests -q -m chip``."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _load(rel):
    from portbench.harness.bench import load_json

    return load_json(ROOT / rel)


@pytest.fixture
def tiny_bigcodec():
    """The flagship's file at a size a CPU test holds (same code paths)."""
    cfg = _load("portbench/configs/bigcodec.json")
    e, d = cfg["model"]["codec_encoder"], cfg["model"]["codec_decoder"]
    e.update(ngf=4, out_channels=16, up_ratios=[2, 5], rnn_num_layers=2)
    d.update(in_channels=16, upsample_initial_channel=32, up_ratios=[5, 2], rnn_num_layers=1,
             codebook_size=64, codebook_dim=4)
    return cfg


@pytest.fixture
def tiny_conformer():
    cfg = _load("portbench/configs/conformer.json")
    for k in ("codec_encoder", "codec_decoder"):
        cfg["model"][k].update(dim=16, n_layers=2, n_head=2, n_fft=40, window_size=40,
                               hop_length=10)
    cfg["model"]["codec_encoder"]["out_channels"] = 16
    cfg["model"]["codec_decoder"].update(in_channels=16, codebook_size=64, codebook_dim=4)
    return cfg


@pytest.fixture
def tiny_mix():
    """The extraction mix at hundredths of its lengths, 2 rows a batch."""
    mix = copy.deepcopy(_load("portbench/traffic/extract-ls.json"))
    mix.update(batch_size=2, quantum_s=0.01, buckets={"0.02": 1, "0.03": 2, "0.05": 1},
               check={"utterances": 4})
    return mix
