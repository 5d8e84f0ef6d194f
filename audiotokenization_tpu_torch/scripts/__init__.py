"""Long-running scripts of the port: the training soak matrix
(``soak_matrix.py``), the stage-2 token-LM soak (``soak_token_lm.py``) and
the serving benchmarks (``bench_serving.py``), each run as
``python -m audiotokenization_tpu_torch.scripts.<name>``. They drive the
port's CLIs and models in-process and import torch, numpy and the port
only."""
from __future__ import annotations

import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the repo: configs/ resolve against it


def repo_path(path) -> str:
    """``path`` as given when absolute, else under the repo root (a config
    such as ``configs/bigcodec.yaml`` reads the same from any directory)."""
    p = Path(path)
    return str(p if p.is_absolute() else ROOT / p)


def card_line(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (the first card); on
    the CPU, a line saying so."""
    if device == "cpu":
        return "cpu (no card)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]
