"""Training metrics (counterpart of ``audiotokenization_tpu/train/metrics.py``;
the codebook histogram only, the rest comes with evaluation)."""
from __future__ import annotations

import torch


def codebook_histogram(indices, codebook_size: int):
    """Count of each code, (codebook_size,) fp32, summable across steps."""
    return torch.bincount(indices.reshape(-1).long(), minlength=codebook_size).float()
