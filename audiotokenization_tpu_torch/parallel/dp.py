"""Data parallelism over ``torch.distributed`` ranks (counterpart of the JAX
package's data-mesh step, ``train/step.py::jit_train_step`` with a mesh).

GSPMD runs the unsharded step over the global batch. Here each rank runs the
step on its own rows, and the step stays the same function:

- every loss term is a mean over the batch, so with equal local batches the
  global loss is the mean of the ranks' losses, and its gradient the mean of
  their gradients: each side's gradients are all-reduced in flat buckets
  (``all_reduce_mean_``, from ``parallel/fsdp.py::ShardedParams`` with no
  leaf cut) after the backward and before ``ClippedAdamW``'s global-norm
  clip (once per update, after all the micro-batches of an accumulated
  step);
- a term that is not a mean over rows (the EMA quantizer's cluster
  statistics and its expiry rows, LFQ's batch entropy, the MoE router's
  capacity, slots and load balance, the STFT loss's spectral convergence)
  reads the group that the step sets (``batch_group``, ``active_group``)
  and reduces across ranks inside the forward. Where such a term is a
  function of sums that ``global_sum`` all-reduces, every rank computes
  the same value, and the all-reduce's backward (a sum of the ranks'
  gradients) times the mean over ranks gives the term's true gradient;
- the logged metrics are all-reduced to their global-batch values (means),
  the codebook histogram summed (``reduce_metrics``).

The collectives are ``torch.distributed``'s own: NCCL on cards, gloo on the
CPU, and gloo on CUDA tensors where several ranks share one card (NCCL
refuses two ranks on one device). A collective that fails raises.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

BUCKET_BYTES = 64 << 20  # one all-reduce per 64 MiB of gradients

_GROUP = None  # the group of the step being traced by the current thread


@contextlib.contextmanager
def batch_group(group):
    """Within the body, ``active_group()`` is ``group`` (None: one process)."""
    global _GROUP
    prev, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = prev


def active_group():
    """The group the batch is split over, inside a data-parallel step; else None."""
    return _GROUP


def world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def global_sum(t, group):
    """The sum of ``t`` over the ranks, differentiable (the backward sums the
    ranks' gradients); ``t`` itself without a group."""
    if group is None:
        return t
    import torch.distributed.nn.functional as dist_fn

    return dist_fn.all_reduce(t, group=group)


def all_gather_rows(t, group):
    """The ranks' ``t`` concatenated along dim 0 in rank order (the global
    batch's row order), without gradient."""
    if group is None:
        return t
    t = t.detach().contiguous()
    out = t.new_empty((world(group) * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def all_gather_shards(shard, axis: int, group):
    """The full tensor whose ``axis`` is cut into the ranks' equal
    ``shard``s, in rank order."""
    n = world(group)
    out = shard.new_empty((n * shard.shape[0], *shard.shape[1:]))
    dist.all_gather_into_tensor(out, shard.detach().contiguous(), group=group)
    return out if axis == 0 else torch.cat(out.chunk(n), dim=axis)


def reduce_scatter_mean(full, axis: int, group):
    """This rank's shard (cut along ``axis``) of the mean of ``full`` over
    the ranks."""
    n = world(group)
    chunks = full.chunk(n, dim=axis)
    out = full.new_empty(chunks[0].shape)
    dist.reduce_scatter_tensor(out, full.contiguous() if axis == 0 else torch.cat(chunks),
                               group=group)
    return out.div_(n)


def _buckets(tensors, bucket_bytes: int):
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > bucket_bytes or t.dtype != bucket[0].dtype):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


def all_reduce_mean_(tensors, group, *, bucket_bytes: int = BUCKET_BYTES):
    """Replace each tensor by its mean over the ranks, in place: one flat
    all-reduce per bucket of ``bucket_bytes``."""
    n = world(group)
    for bucket in _buckets(list(tensors), bucket_bytes):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def collective_device(group) -> torch.device:
    """Where a host value goes to be reduced: the current card under NCCL,
    which takes no CPU tensors, else the CPU."""
    if group is not None and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_agree(ok, group) -> bool:
    """Whether ``ok`` (a bool, or a bool tensor) holds on every rank: one
    all-reduce and one host sync, so every rank takes the same branch (and a
    barrier)."""
    if not torch.is_tensor(ok):
        ok = torch.tensor(bool(ok), device=collective_device(group))
    bad = (~ok).float().reshape(1)
    if group is not None:
        dist.all_reduce(bad, group=group)
    return bool(bad[0] == 0)


def reduce_metrics(metrics: dict, group) -> dict:
    """A step's metrics over the global batch: the mean over the ranks of
    every tensor but ``codebook_hist``, which is summed; one all-reduce.
    Python numbers (the learning rate) are the same on every rank."""
    if group is None:
        return metrics
    keys = [k for k, v in metrics.items() if torch.is_tensor(v) and k != "codebook_hist"]
    n = world(group)
    parts = [torch.stack([metrics[k].detach().float().reshape(()) for k in keys]) / n]
    hist = metrics.get("codebook_hist")
    if hist is not None:
        parts.append(hist.float().reshape(-1))
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=group)
    out = dict(metrics)
    out.update({k: flat[i] for i, k in enumerate(keys)})
    if hist is not None:
        out["codebook_hist"] = flat[len(keys):].view(hist.shape).to(hist.dtype)
    return out

