"""True-edge anti-aliasing inside a window of a longer sequence.

Counterpart of ``_AA_REACH``, ``_replicate_window`` and ``_SPAA`` of
``audiotokenization_tpu/parallel/sp.py``. A window holds the positions
[g0, g0 + L) of a sequence [0, bound); Activation1d's resampling filters
replicate-pad at the sequence's true edges, which may lie inside the
window. The streaming runtime (``models/streaming.py``) needs them. The
rest of the JAX module, sequence-parallel tokenization and synthesis over
several devices, is ROADMAP Queue 1 item 18.
"""
from __future__ import annotations

import torch.nn.functional as F

from ..models import bigcodec
from ..ops.alias_free import downsample1d, resample_filter, upsample1d
from ..ops.snake import snake_beta

# the one-sided reach, in positions at its scale, of one Activation1d
# resample pair: the 2x upsample's taps reach +-3 input positions (K = 12
# windowed sinc, stride 2), the 2x downsample's another +-3, plus 2 margin
_AA_REACH = 8


def _replicate_window(x, g0: int, bound: int):
    """x (B, C, L) holding the global positions g0 + j: positions before 0
    take the value at global 0 and positions >= bound the value at
    bound - 1, wherever the window holds them (a window wholly outside
    [0, bound) gives values its caller discards)."""
    L = x.shape[-1]
    lo = min(max(-g0, 0), L - 1)
    hi = min(max(max(bound, 1) - 1 - g0, 0), L - 1)
    return F.pad(x[..., lo:hi + 1], (lo, L - 1 - hi), mode="replicate")


def _zero_outside(x, g0: int, bound: int):
    """x with its global positions outside [0, bound) set to 0."""
    L = x.shape[-1]
    a = min(max(-g0, 0), L)
    b = min(max(bound - g0, a), L)
    return F.pad(x[..., a:b], (a, L - b))


class _SPAA:
    """Activation1d with the true edges of the sequence inside a window
    starting at global position g0: replicate the input at the true edges,
    2x upsample, snake, replicate the upsampled signal at the (2x) true
    edges, 2x downsample, then zero the positions outside [0, bound) so the
    following convs see the whole sequence's zero padding. The filters'
    error at the window's own edges stays within ``_AA_REACH`` positions,
    which callers provide. Without anti-aliasing a plain snake."""

    def __init__(self, antialias: bool, g0: int, bound: int):
        self._aa = bigcodec._AA(antialias)
        self.antialias = antialias
        self.g0, self.bound = g0, bound

    def __call__(self, x, snake):
        if not self.antialias:
            return self._aa(x, snake)
        filt = resample_filter(2, x.device, x.dtype)
        x = upsample1d(_replicate_window(x, self.g0, self.bound), filt, 2)
        x = snake_beta(x, snake.alpha, snake.beta)
        x = _replicate_window(x, 2 * self.g0, 2 * self.bound)
        return _zero_outside(downsample1d(x, filt, 2), self.g0, self.bound)
