"""Adjacent token merging (ToMe-style) for latent and token streams
(counterpart of ``audiotokenization_tpu/utils/tome.py``).

- ``adjacent_chained_merge``: the cosine similarity of adjacent pairs, the
  top-r links, chained groups (links (A, B) and (B, C) make one group (A,
  B, C): a token starts a group iff its left link is not selected, and the
  group ids are the running sum of the starts), mean-pooled per group;
- ``unmerge``: every token takes its group's pooled value.

The groups are padded to N - r (a validity mask marks the real ones).
Among equal similarities the lower link index wins, as in
``jax.lax.top_k``: the links are taken from a stable descending sort, as
``torch.topk`` promises no order among ties.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class MergeInfo(NamedTuple):
    group_of: torch.Tensor   # (B, N) int64: each token's group
    n_groups: torch.Tensor   # (B,) int64
    mask: torch.Tensor       # (B, G) bool: the groups that hold tokens


def adjacent_chained_merge(x, r: int):
    """x (B, N, C) -> (merged (B, G, C), MergeInfo), G = N - r; r is
    clamped to N - 1, and r <= 0 merges nothing."""
    B, N, C = x.shape
    if r <= 0:
        ids = torch.arange(N, device=x.device).expand(B, N)
        return x, MergeInfo(ids, torch.full((B,), N, device=x.device),
                            torch.ones(B, N, dtype=torch.bool, device=x.device))
    r = min(r, N - 1)
    xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
    sim = (xn[:, :-1] * xn[:, 1:]).sum(-1)  # (B, N - 1)
    top = torch.sort(sim, dim=-1, descending=True, stable=True).indices[:, :r]
    selected = torch.zeros(B, N - 1, dtype=torch.bool, device=x.device).scatter_(1, top, True)
    starts = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=x.device), ~selected], dim=1)
    group_of = starts.long().cumsum(1) - 1
    G = N - r
    sums = x.new_zeros(B, G, C).scatter_add_(1, group_of[..., None].expand(B, N, C), x)
    counts = x.new_zeros(B, G).scatter_add_(1, group_of, x.new_ones(B, N))
    merged = sums / counts.clamp_min(1.0)[..., None]
    return merged, MergeInfo(group_of, group_of[:, -1] + 1, counts > 0)


def unmerge(merged, info: MergeInfo):
    """(B, G, C) -> (B, N, C)."""
    idx = info.group_of[..., None].expand(-1, -1, merged.shape[-1])
    return torch.gather(merged, 1, idx)
