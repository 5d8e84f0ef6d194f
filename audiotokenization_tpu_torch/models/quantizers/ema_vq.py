"""EMA-codebook vector quantizer (counterpart of
``audiotokenization_tpu/models/quantizers/ema_vq.py``; the reference's
lucidrains ``VectorQuantize`` with a Euclidean or cosine codebook).

The codebook is **state**, not a gradient parameter. ``EmaVQ`` keeps it as
buffers under the JAX tree's leaf names (``embed`` (N, D), ``embed_avg``,
``cluster_size`` (N,), ``initted`` (); with ``affine_param`` also
``codebook_mean``, ``codebook_var``, ``batch_mean``, ``batch_var`` (D,)
and ``affine_initted``), so its state dict is the JAX tree's.
``ema_vq_apply`` is a pure function: it reads a state dict and **returns**
the updated one; whoever owns the buffers writes it back
(``EmaVQ.load_state``), when it is to be kept.

Every random draw is explicit: ``draws`` may hold ``expiry`` (N,) int (the
batch rows that replace dead codes), ``kmeans`` (N,) int (the kmeans
seeds) and ``gumbel`` (M, N) uniforms in [1e-9, 1) (stochastic sampling);
a draw missing from ``draws`` comes from ``generator``; with neither,
there is no expiry and no gumbel sampling, as JAX without an ``rng``, and
kmeans seeds from a generator seeded 0. So the tests hand in JAX's own
draws and hold the state update to JAX's.

Distances are fp32 ‖x‖² - 2x·e + ‖e‖² (negative cosine with
``use_cosine_sim``), lowest index on ties; the EMA's per-code counts and
sums are ``bincount`` / ``index_add_`` (the JAX package's one-hot matmul,
without its (M, N) one-hot). ``process_group`` (None: one process)
all-reduces the counts, the sums, the affine batch moments and the
diversity term's mean probabilities, where JAX takes ``psum`` over
``axis_name``, and the kmeans seeds and expiry rows index the global
batch's vectors (every rank's, gathered in rank order), as a data-mesh
step over the whole batch picks them.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import torch
from torch import nn

from ...parallel.dp import all_gather_rows

STATE = ("embed", "embed_avg", "cluster_size", "initted")
AFFINE = ("codebook_mean", "codebook_var", "batch_mean", "batch_var", "affine_initted")


class EmaVQResult(NamedTuple):
    quantized: torch.Tensor  # (B, D, T), x's dtype
    indices: torch.Tensor    # (B, T) int32
    loss: torch.Tensor       # (B,) fp32
    state: dict              # the updated state (the input's in eval)


def _l2norm(t, dim: int = -1):
    return t / torch.linalg.vector_norm(t, dim=dim, keepdim=True).clamp_min(1e-12)


class EmaVQ(nn.Module):
    """The EMA quantizer's state as buffers (module docstring), initialised
    as ``init_ema_vq``: embed N(0, 1) (on the unit sphere with
    ``use_cosine_sim``; zeros with ``kmeans_init``, which fills it from the
    first training batch), ``embed_avg`` a copy, ``cluster_size`` zeros
    (ones for the cosine codebook, as the reference's CosineSimCodebook)."""

    def __init__(self, *, codebook_size: int, dim: int, kmeans_init: bool = False,
                 affine_param: bool = False, use_cosine_sim: bool = False,
                 generator: torch.Generator):
        super().__init__()
        embed = torch.randn((codebook_size, dim), generator=generator)
        if use_cosine_sim:
            embed = _l2norm(embed)
        if kmeans_init:
            embed = torch.zeros((codebook_size, dim))
        init_cluster = torch.ones if use_cosine_sim else torch.zeros
        self.register_buffer("embed", embed)
        self.register_buffer("embed_avg", embed.clone())
        self.register_buffer("cluster_size", init_cluster((codebook_size,)))
        self.register_buffer("initted", torch.tensor(0.0 if kmeans_init else 1.0))
        if affine_param:
            self.register_buffer("codebook_mean", torch.zeros((dim,)))
            self.register_buffer("codebook_var", torch.ones((dim,)))
            self.register_buffer("batch_mean", torch.zeros((dim,)))
            self.register_buffer("batch_var", torch.ones((dim,)))
            self.register_buffer("affine_initted", torch.tensor(0.0))

    def state(self) -> dict:
        """The buffers by name (the live tensors)."""
        return dict(self.named_buffers())

    @torch.no_grad()
    def load_state(self, state: Mapping[str, torch.Tensor]):
        """Write ``state`` (``ema_vq_apply``'s) into the buffers, in place."""
        for name, buf in self.named_buffers():
            buf.copy_(state[name])


def _psum(t, group):
    if group is None:
        return t
    import torch.distributed.nn.functional as dist_fn  # differentiable all-reduce

    return dist_fn.all_reduce(t, group=group)


def _draw(draws, generator, name, make):
    """``draws[name]``, else ``make(generator)``, else None."""
    if draws is not None and name in draws:
        return draws[name]
    if generator is not None:
        return make(generator)
    return None


def _kmeans(seeds, data, n_clusters: int, iters: int = 10, use_cosine_sim: bool = False):
    """kmeans over data (M, D) from the rows ``seeds`` (n_clusters,); always
    (n_clusters, D). Cosine: assignment by dot product, means renormalised."""
    means = data[seeds.long()]
    for _ in range(iters):
        if use_cosine_sim:
            assign = torch.argmax(data @ means.T, dim=1)
        else:
            d = ((data * data).sum(1, keepdim=True) - 2 * data @ means.T
                 + (means * means).sum(1)[None])
            assign = torch.argmin(d, dim=1)
        counts = torch.bincount(assign, minlength=n_clusters).to(data.dtype)[:, None]
        sums = torch.zeros_like(means).index_add_(0, assign, data)
        new = torch.where(counts > 0, sums / counts.clamp_min(1), means)
        if use_cosine_sim:
            new = torch.where(counts > 0, _l2norm(new), new)
        means = new
    return means


def _rotate_to(src, tgt):
    """Rotation-trick straight-through (arXiv 2410.06424): the value of tgt,
    with gradients reaching src as a rotation (its factors detached)."""
    eps = 1e-12
    ns = torch.linalg.vector_norm(src, dim=-1, keepdim=True).clamp_min(eps)
    nt = torch.linalg.vector_norm(tgt, dim=-1, keepdim=True).clamp_min(eps)
    u, q = src / ns, tgt / nt
    w = u + q
    w = (w / torch.linalg.vector_norm(w, dim=-1, keepdim=True).clamp_min(eps)).detach()
    rotated = (src - 2.0 * (src * w).sum(-1, keepdim=True) * w
               + 2.0 * (src * u.detach()).sum(-1, keepdim=True) * q.detach())
    return rotated * (nt / ns).detach()


def ema_vq_apply(state: Mapping[str, torch.Tensor], x, *, decay: float = 0.8,
                 commitment: float = 1.0, eps: float = 1e-5,
                 threshold_ema_dead_code: float = 2.0, training: bool = False,
                 process_group=None, draws: Optional[Mapping[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 sample_codebook_temp: float = 0.0, stochastic_sampling: bool = False,
                 rotation_trick: bool = False, orthogonal_reg_weight: float = 0.0,
                 diversity_weight: float = 0.0, diversity_temperature: float = 100.0,
                 affine_param: bool = False, affine_batch_decay: float = 0.9,
                 affine_codebook_decay: float = 0.99, use_cosine_sim: bool = False,
                 kmeans_init: bool = True) -> EmaVQResult:
    """x (B, D, T) -> EmaVQResult (quantized (B, D, T), indices (B, T),
    loss (B,), the updated state), as the JAX ``ema_vq_apply`` with its
    options: kmeans init on the first training batch (``kmeans_init`` and
    ``initted`` 0), gumbel sampling at ``sample_codebook_temp`` (training),
    the rotation trick, the orthogonal and diversity regularisers
    (training), affine codebook adaptation, the cosine codebook, and
    dead-code expiry (training, ``threshold_ema_dead_code`` > 0, with an
    ``expiry`` draw)."""
    if use_cosine_sim and affine_param:
        raise ValueError("affine_param is a Euclidean-codebook feature "
                         "(the reference wires it only there)")
    B, D, T = x.shape
    flat = x.transpose(1, 2).reshape(-1, D).float()
    if use_cosine_sim:
        flat = _l2norm(flat)
    state = dict(state)
    n_codes = state["embed"].shape[0]
    M = flat.shape[0]

    # the global batch's vectors (rank order), where a draw picks rows of them
    every = flat if not training else all_gather_rows(flat, process_group)
    if training and kmeans_init and float(state["initted"]) <= 0:
        n_all = every.shape[0]
        seeds = _draw(draws, generator, "kmeans",
                      lambda g: torch.randint(0, n_all, (n_codes,), generator=g))
        if seeds is None:
            seeds = torch.randint(0, n_all, (n_codes,),
                                  generator=torch.Generator().manual_seed(0))
        means = _kmeans(seeds.to(flat.device), every, n_codes, use_cosine_sim=use_cosine_sim)
        state.update(embed=means, embed_avg=means,
                     cluster_size=torch.zeros_like(state["cluster_size"]),
                     initted=torch.ones_like(state["initted"]))

    if affine_param and training:
        cb = state["embed"]
        n_vec = _psum(torch.tensor(float(M), device=flat.device), process_group)
        b_mean = _psum(flat.sum(0), process_group) / n_vec
        b_var = _psum(((flat - b_mean) ** 2).sum(0), process_group) / n_vec
        initted = state["affine_initted"] > 0

        def upd(old, new, d):
            return torch.where(initted, old * d + new * (1 - d), new)

        state.update(codebook_mean=upd(state["codebook_mean"], cb.mean(0), affine_codebook_decay),
                     codebook_var=upd(state["codebook_var"], torch.var(cb, 0, correction=0),
                                      affine_codebook_decay),
                     batch_mean=upd(state["batch_mean"], b_mean, affine_batch_decay),
                     batch_var=upd(state["batch_var"], b_var, affine_batch_decay),
                     affine_initted=torch.ones_like(state["affine_initted"]))

    embed = state["embed"]
    if affine_param:
        cb_std = torch.sqrt(state["codebook_var"].clamp_min(1e-5))
        b_std = torch.sqrt(state["batch_var"].clamp_min(1e-5))
        embed = (embed - state["codebook_mean"]) * (b_std / cb_std) + state["batch_mean"]
    if use_cosine_sim:
        dist = -(flat @ embed.T)
    else:
        dist = ((flat * flat).sum(1, keepdim=True) - 2 * flat @ embed.T
                + (embed * embed).sum(1)[None])
    uniform = None
    if training and stochastic_sampling and sample_codebook_temp > 0:
        uniform = _draw(draws, generator, "gumbel",
                        lambda g: torch.rand(dist.shape, generator=g) * (1.0 - 1e-9) + 1e-9)
    if uniform is not None:
        g = -torch.log(-torch.log(uniform.to(dist.device) + 1e-20))
        indices = torch.argmax(-dist / sample_codebook_temp + g, dim=1)
    else:
        indices = torch.argmin(dist, dim=1)
    quantized = embed[indices]

    new_state = state
    if training:
        counts = _psum(torch.bincount(indices, minlength=n_codes).float(), process_group)
        if affine_param:  # the EMA sums accumulate in codebook coordinates
            src = (flat - state["batch_mean"]) * (cb_std / b_std) + state["codebook_mean"]
        else:
            src = flat
        sums = _psum(torch.zeros_like(embed).index_add_(0, indices, src), process_group)
        cluster_size = state["cluster_size"] * decay + counts * (1 - decay)
        embed_avg = state["embed_avg"] * decay + sums * (1 - decay)
        n = cluster_size.sum()
        smoothed = (cluster_size + eps) / (n + n_codes * eps) * n
        new_embed = embed_avg / smoothed[:, None].clamp_min(1e-12)
        if use_cosine_sim:
            new_embed = _l2norm(new_embed)
        if threshold_ema_dead_code > 0:
            rows = _draw(draws, generator, "expiry",
                         lambda g: torch.randint(0, every.shape[0], (n_codes,), generator=g))
            if rows is not None:
                dead = cluster_size < threshold_ema_dead_code
                samples = every[rows.to(flat.device).long()]
                new_embed = torch.where(dead[:, None], samples, new_embed)
                embed_avg = torch.where(dead[:, None], samples, embed_avg)
                cluster_size = torch.where(dead, torch.full_like(cluster_size,
                                                                 threshold_ema_dead_code),
                                           cluster_size)
        new_state = {**state, "embed": new_embed, "embed_avg": embed_avg,
                     "cluster_size": cluster_size}

    loss = commitment * torch.mean(
        (flat.reshape(B, T, D) - quantized.detach().reshape(B, T, D)) ** 2, dim=(1, 2))
    if training and diversity_weight > 0:
        avg_prob = (_psum(torch.softmax(-dist * diversity_temperature, dim=-1).sum(0),
                          process_group) / _psum(torch.tensor(float(M), device=dist.device),
                                                 process_group))
        loss = loss + diversity_weight * torch.sum(avg_prob * torch.log(avg_prob.clamp_min(1e-12)))
    if training and orthogonal_reg_weight > 0:
        normed = _l2norm(embed)
        cos = normed @ normed.T
        loss = loss + orthogonal_reg_weight * (torch.sum(cos ** 2) / n_codes ** 2 - 1.0 / n_codes)
    if rotation_trick:
        q = _rotate_to(flat, quantized)
    else:
        q = flat + (quantized - flat).detach()
    q = q.reshape(B, T, D).transpose(1, 2).to(x.dtype)
    return EmaVQResult(q, indices.to(torch.int32).reshape(B, T), loss, new_state)
