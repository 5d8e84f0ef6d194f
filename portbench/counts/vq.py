"""Counts of the factorized VQ's search (K1's algorithm)."""
from __future__ import annotations


def k1_ops(m: int, n: int, d: int) -> int:
    """m rows against n codes of d dims: per pair the d-long distance and
    the compare, m * n * (2d + 3)."""
    return m * n * (2 * d + 3)


def k1_bytes(m: int, n: int, d: int) -> int:
    """fp32 rows and codebook read once, int32 indices written once."""
    return 4 * (m * d + n * d + m)


def vq_ops(dec: dict, frames: int) -> int:
    """The quantizer's search for ``frames`` frames: the in-projection and K1."""
    dim, d, n = dec["in_channels"], dec["codebook_dim"], dec["codebook_size"]
    return frames * (2 * dim * d + d) + k1_ops(frames, n, d)
